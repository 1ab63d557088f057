"""NAIS — neural attentive item similarity (He et al., TKDE 2018).

Port of ``neurec_tpu/models/general/nais.py`` (model/general_recommender/
NAIS.py:85-180):

* the attended set representation p = sum_j A_j q'_j with
  A = exp(h . act(W x_j + b)) / (sum exp)^beta, x_j = q'_j * q_i (prod,
  ``algorithm=0``) or [q'_j; q_i] (concat, ``algorithm=1``);
* score = n^alpha * <p, q_i> + b_i (+alpha, unlike FISM's -alpha, as the
  reference, NAIS.py:110);
* FISM's training feeds: a positive uses the set minus the target
  (n = |set|), a negative the full set (n = |set| + 1); lambda / gamma /
  eta regularization from ``regs``; ``pretrain_file``: a FISM pickle
  ``[Q_set, Q, bias]`` warm-starts the three tables.

Mirrored deviation: the attention masks by real slot validity (the
reference's sequence mask lets one padding row into a negative's softmax).

``predict`` is attention conditioned on each candidate item. The JAX
package maps over the users' padded rows (``lax.map``); here a batch is
scored over its train edges: the (slot, item) pairs of its users' rows,
derived on the device (``_edges``: an inclusive cumsum of the lengths and
a ``searchsorted`` over ``arange(capacity)``), one user's contiguous and
in its row's order, padded with slot B to a static ``capacity``. Per item
chunk (``capacity x I_c x max(d, w)`` within ``_TRANSIENT`` elements)
the logits of every (edge, item) and their ``exp`` are computed, and the
per-slot sums of the exps and of the exps times <q'_j, q_i> (DeepICF:
times q'_j, the attended rep) are ordered segment sums
(``torch.segment_reduce``, no atomics), the pads in short segments past
the last slot's that no slot reads; so a call reads nothing on the host
and gives the same bits each time. The capacity is a host int that the
caller knows when it makes its program (``predict_capacity``: the most
edges of the real users of any batch of a batch set, rounded up to 8);
without one it is ``B * L_max``, the JAX form's own bound. An empty row
attends to nothing (p = 0), as the JAX form's all-pad row.
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.models.general.fism import padded_rows
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.parallel.mesh import whole_term
from neurec_tpu_torch.pretrain import as_tensor, try_load

_ACTS = {0: torch.relu, 1: torch.sigmoid, 2: torch.tanh,
         "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}
_IN_PLACE = {torch.relu: torch.relu_, torch.sigmoid: torch.sigmoid_, torch.tanh: torch.tanh_}

# elements of one (edges, items, max(d, w)) attention transient in predict: 256 MB of f32
_TRANSIENT = 1 << 26
# most pad edges in one segment of predict's sums (a segment is summed in order by one thread)
_PAD_SEGMENT = 64


def _parse_act(value):
    if isinstance(value, str):
        return _ACTS[value.lower()]
    return _ACTS[int(value)]


@register("NAIS")
class NAIS(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.weight_size = int(config.get("weight_size", 16))
        regs = config.get("regs", [1e-7, 1e-7, 1e-5])
        self.lambda_bilinear = float(regs[0])
        self.gamma_bilinear = float(regs[1])
        self.eta_bilinear = float(regs[2]) if len(regs) > 2 else 0.0
        self.alpha = float(config.get("alpha", 0.0))
        self.beta = float(config.get("beta", 0.5))
        self.algorithm = int(config.get("algorithm", 0))
        self.activation = _parse_act(config.get("activation", 0))
        self.is_pairwise = bool(config.get("is_pairwise", False))
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 4)))
        self.embed_init_method = config.get("embed_init_method", "tnormal")
        self.weight_init_method = config.get("weight_init_method", "he_normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.pretrain_file = config.get("pretrain_file", "")
        self.data_kind = "pairwise" if self.is_pairwise else "pointwise"
        self._rows, self._lens = padded_rows(dataset, self.device)
        self._lens_host = np.diff(dataset.train_matrix.indptr)

    def init_params(self, generator: torch.Generator):
        e_init = get_initializer(self.embed_init_method, self.stddev)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        d, w = self.embedding_size, self.weight_size
        params = {
            "Q_set": e_init(generator, (self.num_items, d)),
            "Q": e_init(generator, (self.num_items, d)),
            "bias": torch.zeros((self.num_items,), dtype=torch.float32, device=generator.device),
            "W": w_init(generator, ((self.algorithm + 1) * d, w)),
            "b": w_init(generator, (1, w)),
            "h": torch.ones((w, 1), dtype=torch.float32, device=generator.device),
        }
        loaded = try_load(self.pretrain_file)
        if loaded is not None:
            fism = loaded[0]
            for i, name in enumerate(("Q_set", "Q", "bias")):
                params[name] = as_tensor(fism[i], self.device)
        return {k: v.to(self.device) for k, v in params.items()}

    def _att_pool(self, params, set_emb, q_target, slot_mask):
        """set_emb (..., L, d); q_target (..., d) -> attended (..., d)."""
        if self.algorithm == 0:
            x = set_emb * q_target[..., None, :]
        else:
            x = torch.cat([set_emb, q_target[..., None, :].expand_as(set_emb)], dim=-1)
        mlp = self.activation(x @ params["W"] + params["b"])
        logits = (mlp @ params["h"])[..., 0]  # (..., L)
        exp_a = torch.exp(logits) * slot_mask
        exp_sum = torch.pow(torch.clamp(torch.sum(exp_a, dim=-1, keepdim=True), min=1e-12), self.beta)
        att = exp_a / exp_sum
        return torch.sum(att[..., None] * set_emb, dim=-2)

    def _set_table(self, params):
        Q_set = self.whole(params, "Q_set")
        return torch.cat([Q_set, Q_set.new_zeros((1, Q_set.shape[1]))], dim=0)

    def _attended(self, params, users, items, exclude_target):
        """Attended reps of (user, item) pairs: the set minus the target
        where ``exclude_target`` (B,) is 1, else the full set; returns
        (p, n, set_emb, q)."""
        rows = self._rows[users]  # (B, L)
        n = self._lens[users].float()
        hit = (rows == items[:, None]).float() * exclude_target[:, None]
        slot_mask = (rows < self.num_items).float() * (1.0 - hit)
        set_emb = self.rows_padded(params, "Q_set", rows)  # (B, L, d)
        q = self.rows(params, "Q", items)
        return self._att_pool(params, set_emb, q, slot_mask), n, set_emb, q

    def _score(self, params, p, num_idx, q, items):
        coeff = torch.pow(torch.clamp(num_idx, min=1.0), self.alpha)
        return coeff * torch.sum(p * q, dim=-1) + params["bias"][items]

    def loss(self, params, batch, weights):
        users = batch["users"]
        w, w3 = weights[:, None], weights[:, None, None]
        reg_w = whole_term(self.eta_bilinear * l2_loss(params["W"]))
        if self.is_pairwise:
            pos, neg = batch["pos_items"], batch["neg_items"]
            ones = torch.ones_like(weights)
            p1, n, se, q1 = self._attended(params, users, pos, ones)
            p2, _, _, q2 = self._attended(params, users, neg, torch.zeros_like(weights))
            y = self._score(params, p1, n, q1, pos) - self._score(params, p2, n + 1.0, q2, neg)
            return (pairwise_loss(self.loss_function, y, weights=weights)
                    + self.lambda_bilinear * l2_loss(se * w3)
                    + self.gamma_bilinear * l2_loss(q2 * w, q1 * w) + reg_w)
        items, labels = batch["items"], batch["labels"]
        p, n, set_emb, q = self._attended(params, users, items, labels)
        y = self._score(params, p, torch.where(labels > 0, n, n + 1.0), q, items)
        return (pointwise_loss(self.loss_function, labels, y, weights=weights)
                + self.lambda_bilinear * l2_loss(set_emb * w3)
                + self.gamma_bilinear * l2_loss(q * w) + reg_w)

    # -- full-catalogue prediction over a batch's train edges -----------------
    def predict_capacity(self, users_b, valid_b=None) -> int:
        """The edge capacity of ``predict`` over the batches ``users_b``
        ((n_batches, B) host ids): the most train pairs of any batch's
        real users (``valid_b`` nonzero; default all), rounded up to 8. A
        batch's pad users trail its real ones, so only their own edges
        fall past it (dropped: their scores are computed and ignored)."""
        lens = self._lens_host[np.asarray(users_b, dtype=np.int64)]
        if valid_b is not None:
            lens = lens * (np.asarray(valid_b) != 0)
        most = int(lens.sum(axis=-1).max()) if lens.size else 0
        return max(8, most + (-most) % 8)

    def _edges(self, users, capacity: int):
        """The train edges of ``users`` (B,) in ``capacity`` static slots:
        (item (E,), slot (E,), segment lengths (B + ceil(E / _PAD_SEGMENT),)).
        A user's edges are contiguous and in its row's order; the pads
        after them have slot B and item ``num_items`` (the set table's
        zero row) and fill the segments past B, ``_PAD_SEGMENT`` at most
        each (one long pad segment would be one thread's serial sum).
        ``capacity`` must hold the pairs of the users that count, which
        come first (``predict_capacity``); the edges past it are
        dropped."""
        B, L = users.shape[0], self._rows.shape[1]
        ends = torch.clamp(torch.cumsum(self._lens[users].long(), 0), max=capacity)
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        e = torch.arange(capacity, device=users.device)
        slot = torch.searchsorted(ends, e, right=True)  # B past the last user's edges
        own = slot.clamp(max=B - 1)
        pos = (e - starts[own]).clamp(max=L - 1)
        item = torch.where(slot < B, self._rows[users[own], pos], self.num_items)
        pads = torch.arange(-(-capacity // _PAD_SEGMENT), device=users.device) * _PAD_SEGMENT
        return item, slot, torch.cat([ends - starts, torch.clamp(capacity - ends[-1] - pads, 0, _PAD_SEGMENT)])

    def _attention_chunks(self, params, users, capacity: int):
        """(set_emb (E, d), segment lengths (``_edges``), chunks) of the
        batch's edges; ``chunks`` yields, per item chunk, (item slice, Q
        chunk, exp of the logits (E, I_c), each slot's (sum of exp)^beta
        (B, I_c)). The pads sit in the segments past B, which no slot
        reads. The logits' first layer is one product: ``(s * q) @ W + b``
        as ``[s, 1]`` against W scaled by each item's q with b below
        (``algorithm=0``), ``[s; q] @ W + b`` as ``s @ W_s`` once plus
        ``q @ W_q + b`` a chunk (``algorithm=1``); the activation runs in
        place."""
        B, d, w = users.shape[0], self.embedding_size, self.weight_size
        item, _, lengths = self._edges(users, capacity)
        set_emb = self._set_table(params)[item]  # (E, d); a pad's row is zero
        E = set_emb.shape[0]
        Q, W, b, h = self.whole(params, "Q"), params["W"], params["b"], params["h"]
        lhs = torch.cat([set_emb, set_emb.new_ones((E, 1))], dim=1) if self.algorithm == 0 else set_emb @ W[:d]
        act = _IN_PLACE[self.activation]

        def parts():
            for sl in chunks(self.num_items, max(1, _TRANSIENT // (capacity * max(d, w)))):
                q = Q[sl]
                n = q.shape[0]
                if self.algorithm == 0:
                    pre = lhs @ torch.cat([(q.t()[:, :, None] * W[:, None, :]).reshape(d, n * w), b.repeat(1, n)])
                else:
                    pre = (lhs[:, None, :] + (q @ W[d:] + b)[None]).view(E, n * w)
                exp_a = torch.exp_((act(pre).view(E * n, w) @ h).view(E, n))
                exp_sum = torch.segment_reduce(exp_a, "sum", lengths=lengths, axis=0, unsafe=True)[:B]
                yield sl, q, exp_a, torch.pow(torch.clamp(exp_sum, min=1e-12), self.beta)

        return set_emb, lengths, parts()

    def _attend_edges(self, params, users, capacity: int):
        """Yields (item slice, attended reps (B, I_c, d), Q chunk) over the
        catalogue in item chunks: each user's set attended for every item
        through ordered segment sums over the batch's edges."""
        B = users.shape[0]
        set_emb, lengths, parts = self._attention_chunks(params, users, capacity)
        for sl, q, exp_a, den in parts:
            p = torch.segment_reduce(exp_a[:, :, None] * set_emb[:, None, :], "sum", lengths=lengths, axis=0,
                                     unsafe=True)[:B]
            yield sl, p / den[:, :, None], q

    def _coeff(self, users):
        """n^alpha of each user's set, (B, 1)."""
        return torch.pow(torch.clamp(self._lens[users].float(), min=1.0), self.alpha)[:, None]

    def _capacity(self, users, capacity) -> int:
        return int(capacity) if capacity is not None else users.shape[0] * self._rows.shape[1]

    def predict(self, params, users, capacity=None):
        """(B, I) scores of ``users`` over ``capacity`` edge slots (the
        caller's ``predict_capacity``; None: B * L_max): <p, q_i> as each
        slot's sum over its edges of exp * <q'_j, q_i>, over the sum of
        exp to the beta."""
        B, coeff, bias = users.shape[0], self._coeff(users), params["bias"]
        set_emb, lengths, parts = self._attention_chunks(params, users, self._capacity(users, capacity))
        out = []
        for sl, q, exp_a, den in parts:
            num = torch.segment_reduce(exp_a * (set_emb @ q.t()), "sum", lengths=lengths, axis=0, unsafe=True)[:B]
            out.append(coeff * (num / den) + bias[sl])
        return torch.cat(out, dim=1)
