"""Caser — convolutional sequence embedding (Tang & Wang, WSDM 2018).

Port of ``neurec_tpu/models/sequential/caser.py`` (model/sequential_
recommender/Caser.py:40-209):

* sliding windows per user: ``seq_L`` input items -> ``seq_T`` targets; a
  user with fewer than L + T items gives one pre-padded window;
* a vertical convolution (``nv`` filters over the L axis) and horizontal
  ones (``nh`` filters of heights 1..L, max-pooled over positions),
  concatenated -> dropout -> dense(relu) -> concatenated with the user
  embedding: a (B, 2d) vector;
* the targets scored against a separate (num_items, 2d) table plus a
  bias; mean binary CE over the T positives and ``neg_samples`` negatives,
  fresh each step and excluded from the user's train items; l2_reg on the
  four regularized tables; Adam. A short user's pad targets score as the
  last item, with no gradient to it (the JAX gather clamps an index past
  the table, its gradient drops it), kept;
* the reference's quirk kept: the evaluation scores WITHOUT the item bias
  (Caser.py:122), ``(z, P_u) . item_emb``: K1 at 2 x factors_num.

The convolutions are einsums over the (B, L, d) window, as in the JAX
package. A custom epoch: ``_perm`` and a seed a step, then each step
``_negatives`` and the dropout mask (``_bernoulli``) from its own generator;
on a CUDA device the steps are CUDA-graph replays (``epoch_steps``). On a mesh each step is split over 'data' as
the JAX package's (``caser.py:167-173``): the negatives drawn for the whole
batch and cut to this rank's rows, the dropout mask likewise
(``split_draw``), the means' weight counts the whole batch's
(``batch_sum``) and the L2 term over the whole tables counted once
(``whole_term``).
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.data.sequences import pad_sequences
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SeqDraws
from neurec_tpu_torch.ops.initializers import glorot_uniform
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step
from neurec_tpu_torch.trainer import OptaxAdam


@register("Caser")
class Caser(SeqDraws, Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.lr = float(config.get("lr", 0.001))
        self.l2_reg = float(config.get("l2_reg", 0.001))
        self.d = int(config.get("factors_num", 50))
        self.L = int(config.get("seq_L", 5))
        self.T = int(config.get("seq_T", 3))
        self.nv = int(config.get("nv", 4))
        self.nh = int(config.get("nh", 16))
        self.dropout = float(config.get("dropout", 0.5))
        self.neg_samples = int(config.get("neg_samples", 3))

        train_dict = dataset.get_user_train_dict(by_time=True)
        users_list, seq_list, pos_list = [], [], []
        test_seq = np.full((self.num_users, self.L), self.num_items, dtype=np.int64)
        seq_len = self.L + self.T
        for user in sorted(train_dict.keys()):
            seq_items = train_dict[user]
            if len(seq_items) >= seq_len:
                wins = [seq_items[i - seq_len: i] for i in range(len(seq_items), seq_len - 1, -1)]
            else:
                wins = [pad_sequences([seq_items], value=self.num_items, max_len=seq_len, padding="pre",
                                      truncating="pre")[0]]
            test_seq[user] = wins[0][-self.L:]
            for win in wins:
                users_list.append(user)
                seq_list.append(win[: self.L])
                pos_list.append(win[-self.T:])

        def put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)

        self._users, self._seqs, self._poss = put(users_list), put(seq_list), put(pos_list)
        self._user_test_seq = put(test_seq)
        self._padded_items = put(build_padded_positives(dataset.train_matrix).items)

    def make_optimizer(self):
        return lambda params: OptaxAdam([p for _, p in param_leaves(params)], lr=self.lr)

    def init_params(self, generator: torch.Generator):
        d, L = self.d, self.L
        params = {
            "user_emb": glorot_uniform(generator, (self.num_users, d)),
            "seq_item_emb": glorot_uniform(generator, (self.num_items, d)),
            "conv_v_w": glorot_uniform(generator, (L, self.nv)),
            "conv_v_b": torch.zeros((self.nv,)),
            "conv_h": [],
            "fc1_w": glorot_uniform(generator, (self.nv * d + self.nh * L, d)),
            "fc1_b": torch.zeros((d,)),
            "item_emb": glorot_uniform(generator, (self.num_items, 2 * d)),
            "item_bias": torch.zeros((self.num_items,)),
        }
        for i in range(1, L + 1):
            params["conv_h"].append({"w": glorot_uniform(generator, (i, d, self.nh)), "b": torch.zeros((self.nh,))})
        return map_params(lambda t: t.to(self.device), params)

    def _user_vec(self, params, users, seqs, generator=None):
        """(B,) users and (B, L) item windows -> (B, 2d)."""
        x = self.rows_padded(params, "seq_item_emb", seqs)                           # (B, L, d)
        # vertical: nv filters over the L axis of each embedding column
        out_v = torch.einsum("bld,lv->bdv", x, params["conv_v_w"]) + params["conv_v_b"]
        out_v = out_v.reshape(x.shape[0], self.nv * self.d)
        # horizontal: filters of height i over the whole embedding width
        out_hs = []
        for i, conv in enumerate(params["conv_h"], start=1):
            wins = x.unfold(1, i, 1).permute(0, 1, 3, 2)                              # (B, L - i + 1, i, d)
            conv_out = torch.relu(torch.einsum("bpid,idf->bpf", wins, conv["w"]) + conv["b"])
            out_hs.append(torch.amax(conv_out, dim=1))                              # (B, nh)
        out = torch.cat([out_v] + out_hs, dim=1)
        out = self._dropout(out, generator, self.dropout)
        z = torch.relu(out @ params["fc1_w"] + params["fc1_b"])                     # (B, d)
        return torch.cat([z, self.rows(params, "user_emb", users)], dim=1)

    def caser_loss(self, params, users, seqs, pos, neg, w, generator):
        uvec = self._user_vec(params, users, seqs, generator)
        # a short user's pre-padded targets hold num_items: the JAX package's
        # gather reads the last item there and its gradient drops the index.
        # Kept, for parity
        tar = torch.cat([pos, neg], dim=1)                                          # (B, T + S)
        pad = tar >= self.num_items
        tar = torch.clamp(tar, max=self.num_items - 1)
        tar_emb, tar_bias = self.rows(params, "item_emb", tar), params["item_bias"][tar]
        tar_emb = torch.where(pad[:, :, None], tar_emb.detach(), tar_emb)
        tar_bias = torch.where(pad, tar_bias.detach(), tar_bias)
        logits = torch.einsum("bd,btd->bt", uvec, tar_emb) + tar_bias
        pos_logits, neg_logits = logits[:, : self.T], logits[:, self.T:]
        w2 = w[:, None]
        n_w = batch_sum(torch.sum(w))
        denom_p = torch.clamp(n_w * self.T, min=1.0)
        denom_n = torch.clamp(n_w * self.neg_samples, min=1.0)
        pos_loss = torch.sum(-torch.log(torch.sigmoid(pos_logits) + 1e-24) * w2) / denom_p
        neg_loss = torch.sum(-torch.log(1.0 - torch.sigmoid(neg_logits) + 1e-24) * w2) / denom_n
        reg = whole_term(self.l2_reg * 0.5 * sum(torch.sum(torch.square(self.whole(params, k)))
                                                 for k in ("user_emb", "seq_item_emb", "item_emb", "item_bias")))
        return pos_loss + neg_loss + reg

    def epoch_steps(self, params, opt, generator, max_steps=None, trainer=None) -> Steps:
        """One epoch's steps (``step_graph.Steps``): the slots and a seed a
        step drawn from ``generator`` here; a step reads its slots at the
        cursor and draws its negatives and dropout mask from its own
        generator. ``max_steps`` cuts it to its first steps. With a
        ``trainer`` on a mesh each step is split over 'data'
        (``Trainer.dp_split_for``)."""
        idx, w = self._epoch_slots(generator, int(self._users.shape[0]))
        n_run = idx.shape[0] if max_steps is None else min(idx.shape[0], max_steps)
        seeds = step_seeds(generator, idx.shape[0])[:n_run]
        split = None if trainer is None else trainer.dp_split_for(idx.shape[1])

        def make(cursor, total, idx, w):
            def step(gen):
                idx_s, w_s = at(cursor, idx, w)
                negs = self._negatives(gen, self._padded_items[self._users[idx_s]], self.neg_samples)
                if split is not None:  # this rank's rows of the step
                    idx_s, w_s, negs = trainer.dp_constrain(idx_s, w_s, negs)
                train_step(lambda: self.caser_loss(params, self._users[idx_s], self._seqs[idx_s],
                                                        self._poss[idx_s], negs, w_s, gen),
                                opt, cursor, total, trainer, split, params)
            return step

        return Steps(make, n_run, seeds, opt, split, inputs=dict(idx=idx, w=w), reads=params)

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
        raise RuntimeError("Caser uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        # no item bias at evaluation: the reference's quirk (module docstring)
        return self._user_vec(params, users, self._user_test_seq[users]) @ self.whole(params, "item_emb").T

    def eval_embeddings(self, params, users):
        return self._user_vec(params, users, self._user_test_seq[users]), self.whole(params, "item_emb")
