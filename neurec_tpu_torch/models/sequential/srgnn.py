"""SRGNN — session graphs and a gated GNN (Wu et al., AAAI 2019).

Port of ``neurec_tpu/models/sequential/srgnn.py`` (model/sequential_
recommender/SRGNN.py:20-236):

* training instances: every suffix target of each user's sequence, with a
  ``max_seq_len`` context window (SRGNN.py:34-39), each gathered on the
  device from its user's sequence when its batch comes;
* a graph over each session's UNIQUE items (the pad item a node too, as
  the reference's ``np.unique`` over the padded sequence), with in- and
  out-degree-normalized adjacency (SRGNN.py:180-211), built on the device
  for the whole batch (sort, compare adjacent, cumulative ranks, scatter);
* ``step`` gated-GNN iterations: a GRU cell on
  [A_in (h W_in + b_in); A_out (h W_out + b_out)] (SRGNN.py:76-100);
* the attention readout (a sigmoid MLP against the last item) and, unless
  ``nonhybrid``, its concatenation with the last node's state projected
  by B (SRGNN.py:102-124);
* softmax CE over the catalogue, L2 over every parameter (the reference's
  name filter matches none, so all are regularized);
* Adam with a staircase exponential lr decay every ``lr_dc_step * N /
  batch_size`` steps (SRGNN.py:138-143).

A custom epoch: one permutation of the instances (``_perm``), ``N // B``
steps, the batch clamped to N when the data is smaller than one batch; on
a CUDA device the steps are CUDA-graph replays (``epoch_steps``), the
decayed learning rate read from a device table of the block's steps. On
a mesh each step is split over 'data' as the JAX package's
(``srgnn.py:217-218``): a rank builds its rows' session graphs, its mean
cross-entropy is its share of the whole batch's (``split_mean``) and the
L2 term over every parameter is counted once (``whole_term``). The lr
decay counts steps, the same on every rank.
``predict`` scores the full catalogue per user (the predict tier).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.sequences import pad_sequences
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.gru4rec import _gru_step
from neurec_tpu_torch.models.sequential.seq_common import SeqDraws
from neurec_tpu_torch.parallel.mesh import split_mean, whole_term
from neurec_tpu_torch.step_graph import Steps, at, train_step
from neurec_tpu_torch.trainer import OptaxAdam


def session_graphs(seq: torch.Tensor, sess_len: torch.Tensor, num_items: int, dtype=torch.float32):
    """seq (B, L) post-padded with ``num_items`` -> ``(nodes, alias, a_in,
    a_out)``: (B, L) node items (padded with ``num_items``), (B, L) node of
    each position, and the (B, L, L) normalized in and out adjacency."""
    B, L = seq.shape
    sorted_items, order = torch.sort(seq, dim=1, stable=True)
    is_new = torch.ones_like(seq, dtype=torch.bool)
    is_new[:, 1:] = sorted_items[:, 1:] != sorted_items[:, :-1]
    rank = torch.cumsum(is_new.long(), dim=1) - 1                 # the node of each sorted slot
    alias = torch.empty_like(rank).scatter_(1, order, rank)        # the node of each position
    nodes = torch.full_like(seq, num_items).scatter_(1, rank, sorted_items)
    # edges alias[t] -> alias[t + 1] for t < sess_len - 1; row and column L is a dump slot
    valid = torch.arange(L - 1, device=seq.device)[None, :] < (sess_len[:, None] - 1)
    src = torch.where(valid, alias[:, :-1], L)
    dst = torch.where(valid, alias[:, 1:], L)
    adj = torch.zeros((B, L + 1, L + 1), dtype=dtype, device=seq.device)
    b_idx = torch.arange(B, device=seq.device)[:, None].expand_as(src)
    adj.index_put_((b_idx, src, dst), valid.to(dtype))
    adj = adj[:, :L, :L]
    in_deg = torch.clamp(torch.sum(adj, dim=1), min=1.0)          # (B, L) column sums
    out_deg = torch.clamp(torch.sum(adj, dim=2), min=1.0)         # (B, L) row sums
    return nodes, alias, adj / in_deg[:, None, :], adj.transpose(1, 2) / out_deg[:, None, :]


class _DecayedAdam(OptaxAdam):
    """``optax.adam(optax.exponential_decay(lr, transition, rate,
    staircase=True))``: step t (from 0) at lr * rate^(t // transition), in f32.
    Outside ``count_steps`` the rate is a host float from the host count;
    inside (the steps of ``take_steps``, captured or not) a 0-d device
    tensor read at the device count from a table of the block's rates, built
    at its first step and refilled in place for each call of a kept run, as
    ``OptaxAdam`` reads its bias corrections."""

    def __init__(self, params, lr: float, transition: int, rate: float):
        super().__init__(params, lr=lr)
        self.base_lr, self.transition, self.rate = lr, transition, rate

    def lr_at(self, t: int) -> float:
        """The rate of step ``t`` (from 0), an f32 value."""
        return float(np.float32(self.base_lr) * np.float32(self.rate) ** np.float32(t // self.transition))

    def step(self, closure=None):
        count = self._count
        for gi, group in enumerate(self.param_groups):
            first = group["params"][0]
            if count is None:
                state = self.state.get(first)
                group["lr"] = self.lr_at(int(state["step"]) if state else 0)
                continue

            def rows_of(n, first=first):
                state = self.state.get(first)
                t0 = int(state["step"]) if state else 0
                return np.asarray([self.lr_at(t0 + j) for j in range(n)], dtype=np.float32)
            group["lr"] = count.row(("lr", gi), rows_of, first.device)
        return super().step(closure)


@register("SRGNN")
class SRGNN(SeqDraws, Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.lr = float(config.get("lr", 0.001))
        self.L2 = float(config.get("L2", 1e-5))
        self.hidden_size = int(config.get("hidden_size", 64))
        self.step = int(config.get("step", 1))
        self.lr_dc = float(config.get("lr_dc", 0.1))
        self.lr_dc_step = float(config.get("lr_dc_step", 3))
        self.nonhybrid = bool(config.get("nonhybrid", False))
        self.max_seq_len = int(config.get("max_seq_len", 200))

        user_pos_train = dataset.get_user_train_dict(by_time=True)
        # an instance is (user, end): the context is the user's items
        # [max(0, end - max_len), end), the target the item at end; a user
        # of n items gives ends n - 1, ..., 1 (SRGNN.py:34-39). The contexts
        # are gathered on the device from the users' sequences per batch.
        users = [u for u, s in user_pos_train.items() if len(s) >= 2]
        lens = np.asarray([len(user_pos_train[u]) for u in users], dtype=np.int64)
        self._n_inst = int(np.sum(lens - 1))
        self._max_len = min(self.max_seq_len, int(lens.max()) - 1) if len(users) else 1

        def put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)

        self._inst_user = put(np.repeat(np.asarray(users, dtype=np.int64), lens - 1))
        self._inst_end = put(np.concatenate([np.arange(n - 1, 0, -1) for n in lens]) if len(users) else [])
        self._user_seq = put(pad_sequences([user_pos_train.get(u, []) for u in range(self.num_users)],
                                           value=self.num_items, max_len=max(int(lens.max()) if len(users) else 1, 1),
                                           padding="post"))
        # evaluation: the last max_len items of each user
        eval_seqs = [user_pos_train.get(u, [self.num_items])[-self._max_len:] for u in range(self.num_users)]
        self._eval_seq = put(pad_sequences(eval_seqs, value=self.num_items, max_len=self._max_len, padding="post"))
        self._eval_len = put([min(len(s), self._max_len) for s in eval_seqs])

    def instances(self, idx: torch.Tensor):
        """``(seq (B, max_len) post-padded, sess_len (B,), target (B,))`` of
        instances ``idx``."""
        users, end = self._inst_user[idx], self._inst_end[idx]
        start = torch.clamp(end - self._max_len, min=0)
        pos = start[:, None] + torch.arange(self._max_len, device=idx.device)[None, :]
        valid = pos < end[:, None]
        seq_u = self._user_seq[users]
        seq = torch.where(valid, torch.gather(seq_u, 1, torch.clamp(pos, max=seq_u.shape[1] - 1)), self.num_items)
        return seq, end - start, seq_u.gather(1, end[:, None])[:, 0]

    def make_optimizer(self):
        transition = max(int(self.lr_dc_step * self._n_inst / self.batch_size), 1)
        return lambda params: _DecayedAdam([p for _, p in param_leaves(params)], self.lr, transition, self.lr_dc)

    def init_params(self, generator: torch.Generator):
        d = self.hidden_size
        stdv = 1.0 / np.sqrt(d)

        def uni(shape):
            return (2.0 * torch.rand(shape, generator=generator, device=generator.device) - 1.0) * stdv

        params = {
            "embedding": uni((self.num_items, d)), "nasr_w1": uni((d, d)), "nasr_w2": uni((d, d)),
            "nasr_v": uni((1, d)), "nasr_b": torch.zeros((d,)), "W_in": uni((d, d)), "b_in": uni((d,)),
            "W_out": uni((d, d)), "b_out": uni((d,)), "B": uni((2 * d, d)),
            "gru": {"w_gate": uni((3 * d, 2 * d)), "b_gate": torch.ones((2 * d,)), "w_cand": uni((3 * d, d)),
                    "b_cand": torch.zeros((d,))},
        }
        return map_params(lambda t: t.to(self.device), params)

    def _forward(self, params, seq, sess_len):
        """(B, L) padded sessions -> (B, num_items) logits."""
        B, L = seq.shape
        d = self.hidden_size
        emb = self.whole(params, "embedding")  # the lookups and the logits over every item
        nodes, alias, a_in, a_out = session_graphs(seq, sess_len, self.num_items, emb.dtype)
        table = torch.cat([emb, emb.new_zeros((1, d))], dim=0)
        h = table[nodes]                                                            # (B, L, d)
        for _ in range(self.step):
            av_in = torch.matmul(a_in, h @ params["W_in"] + params["b_in"])
            av_out = torch.matmul(a_out, h @ params["W_out"] + params["b_out"])
            av = torch.cat([av_in, av_out], dim=-1)                                 # (B, L, 2d)
            h = _gru_step(params["gru"], torch.tanh, av.reshape(-1, 2 * d), h.reshape(-1, d)).reshape(B, L, d)
        mask = (torch.arange(L, device=seq.device)[None, :] < sess_len[:, None]).to(h.dtype)
        last_alias = torch.gather(alias, 1, torch.clamp(sess_len - 1, min=0)[:, None])[:, 0]
        last_h = h[torch.arange(B, device=seq.device), last_alias]                  # (B, d)
        seq_h = torch.gather(h, 1, alias[:, :, None].expand(B, L, d))               # (B, L, d)
        m = torch.sigmoid((last_h @ params["nasr_w1"])[:, None, :] + seq_h @ params["nasr_w2"] + params["nasr_b"])
        coef = (m @ params["nasr_v"].T)[:, :, 0] * mask
        attended = torch.sum(coef[:, :, None] * seq_h, dim=1)
        sess_emb = attended if self.nonhybrid else torch.cat([attended, last_h], dim=-1) @ params["B"]
        return sess_emb @ emb.T

    def batch_loss(self, params, idx):
        seq, sess_len, tar = self.instances(idx)
        l2 = sum(0.5 * torch.sum(torch.square(p)) for _, p in param_leaves(self.whole_tree(params)))
        return split_mean(F.cross_entropy(self._forward(params, seq, sess_len), tar)) + whole_term(self.L2 * l2)

    def epoch_steps(self, params, opt, generator, max_steps=None, trainer=None) -> Steps:
        """One epoch's steps (``step_graph.Steps``): the permutation drawn
        here, a step's instances read at the cursor; a step draws nothing.
        The reference drops the last partial batch; on data smaller than
        one batch the batch is clamped to N, so that one full batch still
        trains. With a ``trainer`` on a mesh each step is split over 'data'
        (``Trainer.dp_split_for``)."""
        N = self._n_inst
        B = max(min(self.batch_size, N), 1)
        steps = max(N // B, 1)
        idx_all = self._perm(generator, N)[: steps * B].reshape(steps, B)
        n_run = steps if max_steps is None else min(steps, max_steps)
        split = None if trainer is None else trainer.dp_split_for(B)

        def make(cursor, total, idx_all):
            def step(gen):
                idx = at(cursor, idx_all)
                if split is not None:
                    idx = trainer.dp_constrain(idx)
                train_step(lambda: self.batch_loss(params, idx), opt, cursor, total, trainer, split, params)
            return step

        return Steps(make, n_run, None, opt, split, inputs=dict(idx_all=idx_all), reads=params)

    def run_epoch(self, params, opt, generator, max_steps=None, trainer=None):
        """One epoch (``epoch_steps``): ``(params, opt, mean step loss)``;
        its steps CUDA-graph replays where the trainer captures."""
        steps = self.epoch_steps(params, opt, generator, max_steps, trainer)
        return params, opt, self.take_steps(trainer, steps) / max(steps.n, 1)

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_epoch(params, opt_state, generator, max_steps, trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("SRGNN uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        return self._forward(params, self._eval_seq[users], self._eval_len[users])
