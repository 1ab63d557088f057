"""HSTU — the Hierarchical Sequential Transduction Unit (Zhai et al.,
"Actions Speak Louder than Words: Trillion-Parameter Sequential Transducers
for Generative Recommendations", ICML 2024, arXiv:2402.17152; the
generative-recommenders code, ``configs/ml-20m/
hstu-sampled-softmax-n128-large-final.gin``).

The port's one model beyond the JAX zoo: there is no JAX HSTU, and the
tests hold it to a plain reference (``tests/hstu_reference.py``).

A user's history is its last n <= N = ``max_sequence_length`` train items
s_0 .. s_{n-1} by time, with times t_0 .. t_{n-1}, right-padded to N
(pad id ``num_items``, a zero row). Then::

    x_k = E[s_k] sqrt(d) + P[k]                  (dropout in training)
    each of ``num_blocks`` layers (``ops/hstu.py::layer``):
      u, v, q, k = split(SiLU(LN(x) W1 + b1))
      x = x + (dropout(u * LN(A v)) W2 + b2)

with A the pointwise attention under the relative position and time bias
(``ops/hstu.py``). Position i's bias takes the time of the action it
predicts, t_{i+1}; at the last position of an evaluated history that is
the query's time: the user's first test action's time where the dataset
holds test times (``test_time_matrix``), else its last train time.

* evaluation: the L2-normalised output at the last real position against
  the L2-normalised item table, factorised for the evaluator (K1 at d);
* training (a custom epoch, ``build_epoch``): each user's last N + 1 train
  items give N inputs and their next items; at every real position the
  sampled softmax of the target against ``num_negatives`` items drawn
  uniformly from the catalogue (a negative equal to the target masked),
  cosine logits over ``temperature``, cross-entropy averaged over the real
  positions; Adam with b2 0.98; steps replayed as kept graphs where the
  trainer captures. A step draws its negatives (``_uniform``), then its
  dropout masks in the order the encoder applies them (``_bernoulli``).

Departures from the published code: b1 (the published projection has no
bias; it starts at zero here); the time bucket's log in float64
(``ops/hstu.py``); the padded layout (the published encoder is jagged;
the pad positions here affect no real one). Spans: ``neurec.hstu.encode``
[``batch``, ``positions``, ``layers``, ``heads``, ``fused_layers``: the
layers that launched the fused kernels, ``ops/hstu.py::fusable``] where
the encoder runs (eagerly, or at capture); ``neurec.hstu.attn``
[``pairs``, ``real_pairs``, ``fused_layers``: the call's launches of
``hstu_layer_in``, one a (batch, layer) pass that ran fused] once an
evaluation call (``on_evaluate``), from the lengths kept on the host and
the launches the evaluator counted over the call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neurec_tpu_torch import profiling
from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SeqDraws
from neurec_tpu_torch.ops import _build, hstu
from neurec_tpu_torch.ops.initializers import get_initializer, glorot_uniform
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step
from neurec_tpu_torch.trainer import OptaxAdam

NORM_EPS = 1e-6


def by_time(time_matrix):
    """(starts, items, times): each user's train items ordered by time
    (ties in the matrix's column order, as ``csr_to_user_dict_bytime``
    orders them), flat, user ``u``'s at ``starts[u]:starts[u + 1]``.
    Times that span less than 2**32 sort on one packed (user, time) key,
    2.6x as fast as ``lexsort`` over ML-20M's 20 M actions (``PERF.md``);
    wider spans (millisecond stamps) take ``lexsort``."""
    tm = time_matrix.tocsr()
    rows = np.repeat(np.arange(tm.shape[0], dtype=np.int64), np.diff(tm.indptr))
    times = tm.data.astype(np.int64)
    lo = int(times.min()) if len(times) else 0
    if len(times) and int(times.max()) - lo < 2 ** 32 and tm.shape[0] < 2 ** 31:
        order = np.argsort((rows << 32) | (times - lo), kind="stable")  # one key: (user, time)
    else:
        order = np.lexsort((times, rows))
    return tm.indptr.astype(np.int64), tm.indices[order].astype(np.int64), times[order]


def last_window(starts, flat, n_take, width: int, fill):
    """(users, width): each user's last ``n_take`` entries of ``flat``,
    left-aligned, ``fill`` after them."""
    ends = starts[1:]
    col = np.arange(width)[None, :]
    idx = (ends - n_take)[:, None] + col
    keep = col < n_take[:, None]
    return np.where(keep, flat[np.clip(idx, 0, max(len(flat) - 1, 0))] if len(flat) else fill, fill)


@register("HSTU")
class HSTU(SeqDraws, Recommender):
    data_kind = "custom"
    dp_split = False

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.lr = float(config.get("lr", 0.001))
        self.d = int(config.get("item_embedding_dim", 50))
        self.num_blocks = int(config.get("num_blocks", 8))
        self.num_heads = int(config.get("num_heads", 2))
        self.dqk = int(config.get("dqk", 25))
        self.dv = int(config.get("dv", 25))
        self.max_len = int(config.get("max_sequence_length", 200))
        self.dropout_rate = float(config.get("dropout_rate", 0.2))
        self.num_negatives = int(config.get("num_negatives", 128))
        self.temperature = float(config.get("temperature", 0.05))
        N, pad = self.max_len, self.num_items

        starts, items, times = by_time(dataset.time_matrix)
        n = np.diff(starts)
        query = np.where(n > 0, times[np.maximum(starts[1:] - 1, 0)] if len(times) else 0, 0)
        test_times = getattr(dataset, "test_time_matrix", None)
        if test_times is not None and test_times.nnz:
            tt = test_times.tocsr()
            first = np.minimum.reduceat(tt.data.astype(np.int64), np.minimum(tt.indptr[:-1], tt.nnz - 1))
            query = np.where(np.diff(tt.indptr) > 0, first, query)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # evaluation: the last N train items, their times and the query's
        n_eval = np.minimum(n, N)
        ts = last_window(starts, times, n_eval, N + 1, 0)
        ts[np.arange(len(n)), n_eval] = query
        self._eval_seq = dev(last_window(starts, items, n_eval, N, pad))
        self._eval_ts = dev(ts)
        self._eval_len = dev(n_eval.astype(np.int32))
        # each user's attention pairs a layer, computed and needed (on_evaluate)
        self._pairs_host = np.stack(hstu.pair_counts(n_eval, N, self.num_heads, kernel=self.device.type == "cuda"))
        # training: each user with two items, its last n + 1 <= N + 1 by time:
        # n inputs, their next items, and the times of all n + 1
        users = np.flatnonzero(n >= 2)
        n_take = np.minimum(n, N + 1)[users]
        n_tr = n_take - 1
        window = last_window(starts, items, np.minimum(n, N + 1), N + 1, pad)[users]
        real = np.arange(N)[None, :] < n_tr[:, None]
        self._train_users = dev(users.astype(np.int64))
        self._seq = dev(np.where(real, window[:, :N], pad))
        self._tgt = dev(np.where(real, window[:, 1:], pad))
        self._train_ts = dev(last_window(starts, times, np.minimum(n, N + 1), N + 1, 0)[users])
        self._train_len = dev(n_tr.astype(np.int32))

    def make_optimizer(self):
        return lambda params: OptaxAdam([p for _, p in param_leaves(params)], lr=self.lr, b2=0.98)

    def init_params(self, generator: torch.Generator):
        """Item table trunc-normal 0.02, positions trunc-normal sqrt(1/d),
        W1 normal 0.02, W2 glorot-uniform, biases zero, the bias tables
        normal 0.02 (the published code's initialisers)."""
        d, N, h = self.d, self.max_len, self.num_heads
        small = get_initializer("normal", 0.02)
        params = {
            "item_emb": get_initializer("tnormal", 0.02)(generator, (self.num_items, d)),
            "pos_emb": get_initializer("tnormal", (1.0 / d) ** 0.5)(generator, (N, d)),
            "blocks": [],
        }
        width = 2 * h * (self.dv + self.dqk)
        for _ in range(self.num_blocks):
            params["blocks"].append({
                "w1": small(generator, (d, width)),
                "b1": torch.zeros((width,), device=generator.device),
                "w2": glorot_uniform(generator, (h * self.dv, d)),
                "b2": torch.zeros((d,), device=generator.device),
                "w_p": small(generator, (2 * N - 1,)),
                "w_t": small(generator, (hstu.N_BUCKETS + 1,)),
            })
        return map_params(lambda t: t.to(self.device), params)

    def encode(self, params, seq, lengths, ts, generator=None):
        """(B, N) item ids, (B,) lengths, (B, N + 1) times -> (B, N, d)."""
        B, N = seq.shape
        with profiling.span("neurec.hstu.encode", batch=B, positions=N, layers=len(params["blocks"]),
                            heads=self.num_heads) as s:
            x = self.rows_padded(params, "item_emb", seq) * (self.d ** 0.5) + params["pos_emb"][None, :N]
            drop = None
            if generator is not None and self.dropout_rate > 0:
                drop = lambda t: self._dropout(t, generator, self.dropout_rate)  # noqa: E731
                x = drop(x)
            launched = _build.LAUNCHES["hstu_layer_in"]
            for blk in params["blocks"]:
                x = hstu.layer(blk, x, lengths, ts, self.num_heads, self.dqk, self.dv, dropout=drop)
            if s is not None:
                s.attrs["fused_layers"] = _build.LAUNCHES["hstu_layer_in"] - launched
            return x

    def _negatives_uniform(self, generator, shape) -> torch.Tensor:
        """int64 items drawn uniformly from the catalogue (``_uniform``)."""
        u = self._uniform(generator, shape)
        return torch.clamp((u * self.num_items).long(), max=self.num_items - 1)

    def seq_loss(self, params, seq, tgt, lengths, ts, seq_weights, negs, generator):
        """Sampled softmax at every real position, averaged over them."""
        h = F.normalize(self.encode(params, seq, lengths, ts, generator), dim=-1, eps=NORM_EPS)
        pos = F.normalize(self.rows_padded(params, "item_emb", tgt), dim=-1, eps=NORM_EPS)
        neg = F.normalize(self.rows(params, "item_emb", negs), dim=-1, eps=NORM_EPS)
        pos_logit = torch.sum(h * pos, dim=-1, keepdim=True)
        neg_logit = torch.einsum("bnd,bnkd->bnk", h, neg)
        neg_logit = torch.where(negs == tgt[..., None], torch.full_like(neg_logit, -float("inf")), neg_logit)
        logits = torch.cat([pos_logit, neg_logit], dim=-1) / self.temperature
        ce = -torch.log_softmax(logits, dim=-1)[..., 0]
        real = (torch.arange(seq.shape[1], device=seq.device)[None, :] < lengths[:, None]).float()
        real = real * seq_weights[:, None]
        return torch.sum(ce * real) / torch.clamp(torch.sum(real), min=1.0)

    def epoch_steps(self, params, opt, generator, max_steps=None, trainer=None) -> Steps:
        """One epoch's steps (``step_graph.Steps``): the slots and a seed a
        step drawn from ``generator`` here; a step reads its slots at the
        cursor and draws its negatives and dropout masks from its own
        generator. ``max_steps`` cuts it to its first steps."""
        idx, w = self._epoch_slots(generator, int(self._train_users.shape[0]))
        n_run = idx.shape[0] if max_steps is None else min(idx.shape[0], max_steps)
        seeds = step_seeds(generator, idx.shape[0])[:n_run]
        shape = (idx.shape[1], self.max_len, self.num_negatives)

        def make(cursor, total, idx, w):
            def step(gen):
                idx_s, w_s = at(cursor, idx, w)
                negs = self._negatives_uniform(gen, shape)
                train_step(lambda: self.seq_loss(params, self._seq[idx_s], self._tgt[idx_s], self._train_len[idx_s],
                                                 self._train_ts[idx_s], w_s, negs, gen),
                           opt, cursor, total, trainer, None, params)
            return step

        return Steps(make, n_run, seeds, opt, None, inputs=dict(idx=idx, w=w), reads=params)

    def run_epoch(self, params, opt, generator, max_steps=None, trainer=None):
        steps = self.epoch_steps(params, opt, generator, max_steps, trainer)
        return params, opt, self.take_steps(trainer, steps) / max(steps.n, 1)

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_epoch(params, opt_state, generator, max_steps, trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("HSTU uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        u, items = self.eval_embeddings(params, users)
        return u @ items.T

    def eval_embeddings(self, params, users):
        lengths = self._eval_len[users]
        h = self.encode(params, self._eval_seq[users], lengths, self._eval_ts[users])
        last = (lengths.long() - 1).clamp_min(0)
        u = h[torch.arange(h.shape[0], device=h.device), last]
        return (F.normalize(u, dim=-1, eps=NORM_EPS),
                F.normalize(self.whole(params, "item_emb"), dim=-1, eps=NORM_EPS))

    def on_evaluate(self, users: np.ndarray, launches: dict) -> None:
        """The evaluator's call ran over ``users`` (host ids, one a row of
        its batches, pad rows included) and made ``launches``: the span
        ``neurec.hstu.attn`` with the (query, key) pairs its attention
        launches computed and the causal pairs they needed, over its
        layers, and its (batch, layer) passes that ran fused (the launches
        of ``hstu_layer_in``)."""
        with profiling.span("neurec.hstu.attn") as s:
            if s is not None:
                pairs, real = self._pairs_host[:, users].sum(1) * self.num_blocks
                s.attrs.update(pairs=int(pairs), real_pairs=int(real), fused_layers=int(launches["hstu_layer_in"]))
