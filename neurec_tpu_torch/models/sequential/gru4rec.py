"""GRU4Rec — session-based RNN recommendation (Hidasi et al., ICLR 2016).

Port of ``neurec_tpu/models/sequential/gru4rec.py`` (model/sequential_
recommender/GRU4Rec.py:20-250):

* session-parallel minibatches: B user streams advance in lockstep, and a
  finished stream takes the next user with its GRU state reset
  (GRU4Rec.py:134-177). The host builds the epoch's whole schedule, (input
  item, output item, reset, validity) per step and stream, by a ``heapq``
  pass that gives each sequence its (stream, start step) and one numpy
  scatter (``_build_schedule``); its length is pinned up front to the
  list-scheduling bound (``_pin_sched_len``), so an epoch ends in pad steps
  where no entry is valid. A pad step is a true no-op: no forward, no
  optimizer step (the JAX package's ``lax.cond``). The live steps are the
  schedule's first ones (``live_prefix``), and only they are steps: on a
  CUDA device, CUDA-graph replays with the GRU states carried in static
  buffers (``schedule_steps``);
* stacked tf-style GRU cells (gate bias 1.0, candidate act ``hidden_act``)
  written out as ``_gru_step``: the reset gate scales the state BEFORE the
  candidate's product, ``c = act([x, r * h] W_cand + b_cand)``, which is not
  ``torch.nn.GRUCell``'s ``r * (W_hn h + b_hn)``;
* in-batch negatives: logits = out @ emb(Y)^T + b(Y) through ``final_act``,
  the ``top1`` or ``bpr`` loss (GRU4Rec.py:85-101), reg * l2(the batch's
  input and output embeddings and biases); the state is carried from step
  to step without a gradient through it;
* evaluation: each user's history replayed through the cells for a final
  state, scored as ``_affine_eval(state, item_emb, item_bias)`` (K1 at the
  last layer's width + 1); the factorized form exists only with
  ``final_act=linear``.

The epoch's draws are its session order (``_session_order``) and a seed a
step, and, in GRU4RecPlus, each step's extra negatives
(``_extra_negatives``) from the step's own generator.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.sequences import pad_sequences
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SeqDraws
from neurec_tpu_torch.ops.initializers import get_initializer, glorot_uniform
from neurec_tpu_torch.ops.losses import l2_loss, log_loss
from neurec_tpu_torch.parallel.mesh import batch_sum, current_split, slice_rows, whole_term
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step
from neurec_tpu_torch.trainer import OptaxAdam


def _init_gru(generator, in_dim: int, units: int) -> dict:
    return {
        # [x, h] -> 2 units (reset and update gates); tf's gate bias 1.0
        "w_gate": glorot_uniform(generator, (in_dim + units, 2 * units)),
        "b_gate": torch.ones((2 * units,)),
        # [x, r * h] -> units (the candidate)
        "w_cand": glorot_uniform(generator, (in_dim + units, units)),
        "b_cand": torch.zeros((units,)),
    }


def _gru_step(params: dict, act, x, h):
    gates = torch.sigmoid(torch.cat([x, h], dim=-1) @ params["w_gate"] + params["b_gate"])
    r, u = torch.split(gates, h.shape[-1], dim=-1)
    c = act(torch.cat([x, r * h], dim=-1) @ params["w_cand"] + params["b_cand"])
    return u * h + (1.0 - u) * c


def live_prefix(valids: np.ndarray) -> int:
    """The steps of a schedule's (steps, B) ``valids`` before its first step
    without a valid entry; the steps after it must have none."""
    live = valids.any(axis=1)
    n = int(np.argmin(live)) if not live.all() else len(live)
    if live[n:].any():
        raise ValueError("a schedule step without a valid entry comes before a live one")
    return n


@register("GRU4Rec")
class GRU4Rec(SeqDraws, Recommender):
    data_kind = "custom"
    _valid_losses = ("top1", "bpr")

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.lr = float(config.get("lr", 1e-4))
        self.reg = float(config.get("reg", 0.0))
        self.layers = list(config.get("layers", [100]))
        self.hidden_act = {"relu": torch.relu, "tanh": torch.tanh}[config.get("hidden_act", "tanh")]
        self.final_act_name = config.get("final_act", "linear")
        self.loss_name = config.get("loss", self._valid_losses[0])
        if self.loss_name not in self._valid_losses:
            raise ValueError("There is no loss named '%s'." % self.loss_name)
        if self.final_act_name != "linear":
            self.eval_embeddings = None  # predict is not a plain product

        train_dict = dataset.get_user_train_dict(by_time=True)
        self._user_seqs = [train_dict.get(u, []) for u in range(self.num_users)]
        max_len = max((len(s) for s in self._user_seqs), default=1)
        self._eval_seq = torch.from_numpy(pad_sequences(
            self._user_seqs, value=self.num_items, max_len=max_len, padding="post")).long().to(self.device)
        self._sched_len = None  # pinned by build_epoch (_pin_sched_len)

        # user u's transitions are _flat_in / _flat_out[_trans_off[u]: _trans_off[u] + _trans_len[u]]
        self._trans_len = np.array([len(s) - 1 if len(s) >= 2 else 0 for s in self._user_seqs], dtype=np.int64)
        self._trans_off = np.concatenate([[0], np.cumsum(self._trans_len)[:-1]]).astype(np.int64)
        longer = [s for s in self._user_seqs if len(s) >= 2]
        self._flat_in = np.concatenate([np.asarray(s[:-1], np.int32) for s in longer]) if longer else \
            np.zeros(0, np.int32)
        self._flat_out = np.concatenate([np.asarray(s[1:], np.int32) for s in longer]) if longer else \
            np.zeros(0, np.int32)

    def _final_act(self, x):
        if self.final_act_name == "relu":
            return torch.relu(x)
        if self.final_act_name == "leaky_relu":
            return torch.maximum(x, 0.2 * x)
        return x

    def make_optimizer(self):
        return lambda params: OptaxAdam([p for _, p in param_leaves(params)], lr=self.lr)

    def init_params(self, generator: torch.Generator):
        tn = get_initializer("tnormal", 0.01)
        params = {
            "input_emb": tn(generator, (self.num_items, self.layers[0])),
            "item_emb": tn(generator, (self.num_items, self.layers[-1])),
            "item_bias": torch.zeros((self.num_items,)),
            "cells": [],
        }
        in_dim = self.layers[0]
        for units in self.layers:
            params["cells"].append(_init_gru(generator, in_dim, units))
            in_dim = units
        return map_params(lambda t: t.to(self.device), params)

    # -- the session-parallel schedule (host) ---------------------------------
    def _build_schedule(self, perm: np.ndarray, B: int):
        """(steps, B) arrays: input items, output items, resets, validity.

        The lockstep scheduler's per-step choice is a greedy earliest-finish
        assignment (ties to the lower stream): a heapq pass gives each
        sequence its (stream, start step) in O(S log B), then one numpy
        scatter fills every array from the flat transition arrays.
        """
        users = perm[self._trans_len[perm] > 0]
        S = len(users)
        if S == 0:
            z = np.zeros((0, B), np.int32)
            return z, z.copy(), np.zeros((0, B), bool), np.zeros((0, B), bool)
        seg_len = self._trans_len[users]
        heap = [(0, b) for b in range(min(B, S))]
        b_arr = np.zeros(S, dtype=np.int64)
        t_arr = np.zeros(S, dtype=np.int64)
        for k in range(S):
            t, b = heapq.heappop(heap)
            b_arr[k], t_arr[k] = b, t
            heapq.heappush(heap, (t + int(seg_len[k]), b))
        T = int(np.max(t_arr + seg_len))

        total = int(seg_len.sum())
        seg_off = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
        within = np.arange(total, dtype=np.int64) - np.repeat(seg_off, seg_len)
        dst = (np.repeat(t_arr, seg_len) + within) * B + np.repeat(b_arr, seg_len)
        src = np.repeat(self._trans_off[users], seg_len) + within
        ins = np.zeros(T * B, dtype=np.int32)
        outs = np.zeros(T * B, dtype=np.int32)
        valids = np.zeros(T * B, dtype=bool)
        resets = np.zeros(T * B, dtype=bool)
        ins[dst] = self._flat_in[src]
        outs[dst] = self._flat_out[src]
        valids[dst] = True
        resets[t_arr * B + b_arr] = True
        resets[:B] = True  # step 0 starts every stream from a fresh state
        return ins.reshape(T, B), outs.reshape(T, B), resets.reshape(T, B), valids.reshape(T, B)

    def _pin_sched_len(self, B: int) -> int:
        """The schedule's length, pinned up front to the list-scheduling
        bound ceil(total / B) + max_seg (the earliest-finish assignment
        never exceeds it), rounded up to 128; the tail is pad steps."""
        total = int(self._trans_len.sum())
        max_seg = int(self._trans_len.max()) if len(self._trans_len) else 0
        bound = -(-total // max(B, 1)) + max_seg
        return ((max(bound, 1) + 127) // 128) * 128

    def _session_order(self, generator: torch.Generator, n: int) -> np.ndarray:
        """The epoch's order of the users, on the host: a numpy permutation
        seeded from the generator, as the JAX package seeds it from its key."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator, device=generator.device))
        return np.random.RandomState(seed).permutation(n)

    def _extra_negatives(self, generator):
        """GRU4RecPlus's extra sampled negatives of a step; none here."""
        return None

    def schedule(self, generator: torch.Generator):
        """The epoch's schedule, padded to the pinned length: (L, B) numpy
        ins, outs, resets (True on the pad steps) and valids."""
        B = self.batch_size
        if self._sched_len is None:
            self._sched_len = self._pin_sched_len(B)
        ins, outs, resets, valids = self._build_schedule(self._session_order(generator, self.num_users), B)
        pad = ((0, self._sched_len - ins.shape[0]), (0, 0))  # >= 0 by the bound
        return (np.pad(ins, pad), np.pad(outs, pad), np.pad(resets, pad, constant_values=True),
                np.pad(valids, pad))

    def _loss_from_logits(self, logits, valid_rows, valid_cols, B, lo=0):
        """logits (k, C) of the streams ``lo .. lo+k-1`` (all B of them
        outside a split step); valid_rows (k,) masks idle streams,
        valid_cols (C,). A split step's whole-batch counts are summed over
        'data' (``batch_sum``)."""
        pos = torch.diagonal(logits[:, lo:lo + logits.shape[0]])[:, None]
        vv = valid_rows[:, None] * valid_cols[None, :]
        if self.loss_name == "bpr":
            return torch.sum(log_loss(pos - logits) * vv) / torch.clamp(batch_sum(torch.sum(vv)), min=1.0)
        nvalid = torch.clamp(torch.sum(vv, dim=1), min=1.0)
        loss1 = torch.sum(torch.sigmoid(-pos + logits) * vv, dim=1) / nvalid
        loss2 = (torch.sum(torch.sigmoid(torch.square(logits)) * vv, dim=1) / nvalid
                 - torch.sigmoid(torch.square(pos[:, 0])) / B)
        return torch.sum((loss1 + loss2) * valid_rows) / torch.clamp(batch_sum(torch.sum(valid_rows)), min=1.0)

    def step_loss(self, params, states, in_i, out_i, valid, extra):
        """One step's ``(loss, new states)`` from ``states`` (reset already).

        ``in_i``, ``out_i`` and ``valid`` are the whole step's streams;
        ``states`` holds this rank's streams: all of them, or in a split
        step (``parallel.mesh.batch_split``) its rows of the streams, as
        the JAX package splits the session lanes over 'data'
        (``gru4rec.py:238``). The rows of the logits are this rank's
        streams, the columns every stream's target (the in-batch
        negatives), so the column terms of the regulariser count once."""
        B = in_i.shape[0]
        split = current_split()
        rows = slice(0, B) if split is None else slice(split.index * states[0].shape[0],
                                                       (split.index + 1) * states[0].shape[0])
        if extra is None:
            y, valid_cols = out_i, valid
        else:
            y = torch.cat([out_i, extra])
            valid_cols = torch.cat([valid, valid.new_ones(extra.shape)])
        x = self.rows(params, "input_emb", in_i[rows])
        h, new_states = x, []
        for cell, s in zip(params["cells"], states):
            h = _gru_step(cell, self.hidden_act, h, s)
            new_states.append(h)
        items_embed, items_bias = self.rows(params, "item_emb", y), params["item_bias"][y]
        logits = self._final_act(h @ items_embed.T + items_bias)
        loss = self._loss_from_logits(logits, valid[rows], valid_cols, B, rows.start)
        reg = self.reg * (l2_loss(x * valid[rows][:, None]) + whole_term(l2_loss(items_embed * valid_cols[:, None]))
                          + whole_term(l2_loss(items_bias * valid_cols)))
        return loss + reg, new_states

    def schedule_steps(self, params, opt, ins, outs, resets, valids, generator, max_steps=None,
                       trainer=None) -> Steps:
        """The steps of a schedule (``step_graph.Steps``): its steps with a
        valid entry, which are its first ones (every stream runs from step
        0 without a gap, so the last stream to finish is busy at every step
        before the end: the pad steps are the tail); a pad step is no step
        at all, as the JAX package's ``lax.cond`` makes it one. A seed a
        step of the schedule is drawn from ``generator`` here; a step reads
        its streams at the cursor, resets and carries the GRU states in
        static buffers, and draws GRU4RecPlus's extra negatives from its own
        generator. With a ``trainer`` on a mesh the streams split over
        'data': each rank carries its streams' states and computes their
        rows. The run's tensors span the schedule's ``n_run`` steps (its
        pinned length, or ``max_steps``), the same shapes every epoch, of
        which the steps take the live prefix: a kept run holds across
        epochs whose live prefixes differ (``Steps.most``)."""
        B = self.batch_size
        n_run = ins.shape[0] if max_steps is None else min(ins.shape[0], max_steps)
        n_live = live_prefix(valids[:n_run])
        dev = self.device
        ins_d, outs_d = (torch.from_numpy(a[:n_run]).long().to(dev) for a in (ins, outs))
        resets_d, valids_d = (torch.from_numpy(a[:n_run].astype(np.float32)).to(dev) for a in (resets, valids))
        seeds = step_seeds(generator, ins.shape[0])[:n_live]
        split = None if trainer is None else trainer.dp_split_for(B)
        n_rows = B if split is None else B // split.count
        states = [torch.zeros((n_rows, n), device=dev) for n in self.layers]

        def make(cursor, total, ins_d, outs_d, resets_d, valids_d, states):
            def step(gen):
                in_s, out_s, reset, valid = at(cursor, ins_d, outs_d, resets_d, valids_d)
                if split is not None:
                    reset = slice_rows(reset, split.mesh)
                carried = [st * (1.0 - reset[:, None]) for st in states]
                extra = self._extra_negatives(gen)
                new_states = []

                def loss():
                    loss_s, new = self.step_loss(params, carried, in_s, out_s, valid, extra)
                    new_states.extend(new)
                    return loss_s

                train_step(loss, opt, cursor, total, trainer, split, params)
                for st, new in zip(states, new_states):
                    st.copy_(new.detach())
            return step

        inputs = dict(ins_d=ins_d, outs_d=outs_d, resets_d=resets_d, valids_d=valids_d, states=states)
        return Steps(make, n_live, seeds, opt, split, inputs=inputs, reads=params, most=n_run)

    def run_schedule(self, params, opt, ins, outs, resets, valids, generator, max_steps=None, trainer=None):
        """The steps of a schedule (``schedule_steps``), ``(params, opt,
        loss)``: the sum of the losses over the number of steps with a valid
        entry; CUDA-graph replays where the trainer captures."""
        steps = self.schedule_steps(params, opt, ins, outs, resets, valids, generator, max_steps, trainer)
        return params, opt, self.take_steps(trainer, steps) / max(steps.n, 1)

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_schedule(params, opt_state, *self.schedule(generator), generator, max_steps,
                                     trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("GRU4Rec uses build_epoch (data_kind='custom')")

    def _user_states(self, params, users):
        """Each user's history replayed through the cells -> the last
        layer's final state (B, layers[-1])."""
        seq = self._eval_seq[users]
        valid = seq != self.num_items
        xs = self.rows(params, "input_emb", torch.clamp(seq, max=self.num_items - 1))  # (B, T, d)
        states = [xs.new_zeros((seq.shape[0], n)) for n in self.layers]
        for t in range(seq.shape[1]):
            h, v = xs[:, t], valid[:, t, None]
            new_states = []
            for cell, s in zip(params["cells"], states):
                h = torch.where(v, _gru_step(cell, self.hidden_act, h, s), s)
                new_states.append(h)
            states = new_states
        return states[-1]

    def predict(self, params, users):
        return self._final_act(self._user_states(params, users) @ self.whole(params, "item_emb").T
                               + params["item_bias"])

    def eval_embeddings(self, params, users):
        # exact for final_act=linear only: __init__ drops the hook otherwise
        return self._affine_eval(self._user_states(params, users), self.whole(params, "item_emb"),
                                 params["item_bias"])
