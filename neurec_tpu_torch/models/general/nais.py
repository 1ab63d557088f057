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

``predict`` is attention conditioned on each candidate item, one user at a
time as the JAX package's ``lax.map``: each user's row is cut to its own
length (its masked pad slots add exact zeros) and the (items, L, d)
transient runs over item chunks of at most ``_TRANSIENT`` elements.
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

# elements of one (items, L, width) attention transient in predict: 128 MB of f32
_TRANSIENT = 1 << 25


def _parse_act(value):
    if isinstance(value, str):
        return _ACTS[value.lower()]
    return _ACTS[int(value)]


@register("NAIS")
class NAIS(Recommender):
    # ``predict`` cuts each user's train row to its length on the host
    # (``_user_rows``), where the JAX package maps over the padded row: its
    # evaluation and export run eagerly, not as CUDA graphs
    eval_graphs = False

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

    # -- full-catalogue prediction, one user at a time ------------------------
    def _user_rows(self, users):
        """(row, n) of each user: the sorted train row cut to its length (at
        least one slot) and n = |set| as f32 on the device."""
        ids = users.cpu().numpy()
        return [(self._rows[u, : max(int(self._lens_host[u]), 1)], self._lens[u].float()) for u in ids]

    def _attend_catalogue(self, params, set_table, row, Q=None):
        """(I, d) attended reps of one user's set for every candidate item
        (``set_table`` whole; ``Q`` the whole target table, gathered here
        when None)."""
        if Q is None:
            Q = self.whole(params, "Q")
        set_emb = set_table[row]  # (L, d)
        L = row.shape[0]
        slot_mask = (row < self.num_items).float()[None, :]
        width = max((self.algorithm + 1) * self.embedding_size, self.weight_size)
        return torch.cat([
            self._att_pool(params, set_emb[None].expand(sl.stop - sl.start, L, set_emb.shape[1]), Q[sl], slot_mask)
            for sl in chunks(self.num_items, max(1, _TRANSIENT // (L * width)))
        ], dim=0)

    def predict(self, params, users):
        set_table = self._set_table(params)
        Q, bias = self.whole(params, "Q"), params["bias"]
        out = []
        for row, n in self._user_rows(users):
            p = self._attend_catalogue(params, set_table, row, Q)
            coeff = torch.pow(torch.clamp(n, min=1.0), self.alpha)
            out.append(coeff * torch.sum(p * Q, dim=-1) + bias)
        return torch.stack(out)
