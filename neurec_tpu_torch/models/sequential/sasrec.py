"""SASRec — self-attentive sequential recommendation (Kang & McAuley, ICDM 2018).

Port of ``neurec_tpu/models/sequential/sasrec.py`` (model/sequential_
recommender/SASRec.py:268-443):

* item embeddings with a zero pad row at ``num_items``, scaled by sqrt(d),
  plus learned position embeddings;
* ``num_blocks`` x [pre-LN causal attention (the residual adds the
  normalized input) -> pre-LN FFN] (``ops/attention.py``), the pad
  positions zeroed after each block, a final LN;
* training: per user (seq = items[:-1], pos = items[1:]) pre-padded and
  pre-truncated to ``max_len``; one fresh negative per position, excluded
  from the user's train items; binary CE per position averaged over the
  real targets; Adam with b2 = 0.98; dropout ``dropout_rate`` on the input,
  the attention weights and both FFN layers;
* evaluation: the last position's state against the scaled item table,
  factorized for the evaluator (K1 at hidden_units).

A custom epoch (``build_epoch``): a permutation of ``steps * B`` user
slots (``_perm``) and a seed a step from the epoch's generator, then each
step its negatives (``_negatives``) and its dropout masks (``_bernoulli``,
in the order the encoder applies them) from its own generator; on a CUDA
device the steps are CUDA-graph replays (``epoch_steps``).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.data.sequences import pad_sequences
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SeqDraws
from neurec_tpu_torch.ops.attention import feedforward, init_dense, init_layer_norm, layer_norm, multihead_attention
from neurec_tpu_torch.ops.initializers import glorot_uniform
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step
from neurec_tpu_torch.trainer import OptaxAdam


@register("SASRec")
class SASRec(SeqDraws, Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.lr = float(config.get("lr", 0.001))
        self.l2_emb = float(config.get("l2_emb", 0.0))
        self.hidden_units = int(config.get("hidden_units", 50))
        self.dropout_rate = float(config.get("dropout_rate", 0.5))
        self.max_len = int(config.get("max_len", 50))
        self.num_blocks = int(config.get("num_blocks", 2))
        self.num_heads = int(config.get("num_heads", 1))

        user_pos_train = dataset.get_user_train_dict(by_time=True)
        train_users = [u for u, seq in user_pos_train.items() if len(seq) >= 2]
        pad = self.num_items

        def padded(seqs):
            table = pad_sequences(seqs, value=pad, max_len=self.max_len, padding="pre", truncating="pre")
            return torch.from_numpy(table).long().to(self.device)

        self._train_users = torch.tensor(train_users, dtype=torch.long, device=self.device)
        self._seq = padded([user_pos_train[u][:-1] for u in train_users])
        self._pos = padded([user_pos_train[u][1:] for u in train_users])
        # evaluation: the whole history of each user, pre-padded
        self._eval_seq = padded([user_pos_train.get(u, [pad]) for u in range(self.num_users)])
        # the negatives' exclusion rows
        self._padded_items = torch.from_numpy(build_padded_positives(dataset.train_matrix).items).long().to(
            self.device)

    def make_optimizer(self):
        return lambda params: OptaxAdam([p for _, p in param_leaves(params)], lr=self.lr, b2=0.98)

    def init_params(self, generator: torch.Generator):
        d = self.hidden_units
        params = {
            "item_emb": glorot_uniform(generator, (self.num_items, d)),
            "pos_emb": glorot_uniform(generator, (self.max_len, d)),
            "blocks": [],
            "final_ln": init_layer_norm(d),
        }
        for _ in range(self.num_blocks):
            params["blocks"].append({
                "ln1": init_layer_norm(d),
                "att": {"q": init_dense(generator, d, d), "k": init_dense(generator, d, d),
                        "v": init_dense(generator, d, d)},
                "ln2": init_layer_norm(d),
                "ffn": {"w1": init_dense(generator, d, d), "w2": init_dense(generator, d, d)},
            })
        return map_params(lambda t: t.to(self.device), params)

    def _item_rows(self, params, ids):
        """Rows of the item table with the zero pad row (id num_items),
        scaled by sqrt(d)."""
        return self.rows_padded(params, "item_emb", ids) * (self.hidden_units ** 0.5)

    def encode(self, params, seq_ids, generator=None):
        """(B, T) item ids -> (B, T, d) final states; dropout with a generator."""
        T = seq_ids.shape[1]
        x = self._item_rows(params, seq_ids) + params["pos_emb"][None, :T, :]
        drop = None
        if generator is not None and self.dropout_rate > 0:
            drop = lambda t: self._dropout(t, generator, self.dropout_rate)  # noqa: E731
            x = drop(x)
        valid = (seq_ids != self.num_items).float()
        x = x * valid[:, :, None]
        for blk in params["blocks"]:
            x = multihead_attention(blk["att"], layer_norm(blk["ln1"], x), x, valid, self.num_heads, causal=True,
                                    dropout=drop)
            x = feedforward(blk["ffn"], layer_norm(blk["ln2"], x), dropout=drop)
            x = x * valid[:, :, None]
        return layer_norm(params["final_ln"], x)

    def seq_loss(self, params, seq, pos, neg, seq_weights, generator):
        """Binary CE per position averaged over the real targets (SASRec.py:369-375)."""
        h = self.encode(params, seq, generator)
        pos_logits = torch.sum(h * self._item_rows(params, pos), dim=-1)
        neg_logits = torch.sum(h * self._item_rows(params, neg), dim=-1)
        is_target = (pos != self.num_items).float() * seq_weights[:, None]
        pos_loss = -torch.log(torch.sigmoid(pos_logits) + 1e-24) * is_target
        neg_loss = -torch.log(1.0 - torch.sigmoid(neg_logits) + 1e-24) * is_target
        loss = torch.sum(pos_loss + neg_loss) / torch.clamp(batch_sum(torch.sum(is_target)), min=1.0)
        if self.l2_emb > 0:
            loss = loss + whole_term(self.l2_emb * 0.5 * (torch.sum(torch.square(self.whole(params, "item_emb")))
                                                          + torch.sum(torch.square(params["pos_emb"]))))
        return loss

    def epoch_steps(self, params, opt, generator, max_steps=None, trainer=None) -> Steps:
        """One epoch's steps (``step_graph.Steps``): the slots and a seed a
        step drawn from ``generator`` here; a step reads its slots at the
        cursor and draws its negatives and dropout masks from its own
        generator. ``max_steps`` cuts it to its first steps. With a
        ``trainer`` on a mesh each step is split over 'data' as the JAX
        package's (``sasrec.py:180-185``): the negatives drawn for the
        whole batch, then this rank's rows of the slots, weights and
        negatives (``Trainer.dp_constrain``)."""
        idx, w = self._epoch_slots(generator, int(self._train_users.shape[0]))
        n_run = idx.shape[0] if max_steps is None else min(idx.shape[0], max_steps)
        seeds = step_seeds(generator, idx.shape[0])[:n_run]
        split = None if trainer is None else trainer.dp_split_for(idx.shape[1])

        def make(cursor, total, idx, w):
            def step(gen):
                idx_s, w_s = at(cursor, idx, w)
                negs = self._negatives(gen, self._padded_items[self._train_users[idx_s]], self.max_len)
                if split is not None:
                    idx_s, w_s, negs = trainer.dp_constrain(idx_s, w_s, negs)
                train_step(lambda: self.seq_loss(params, self._seq[idx_s], self._pos[idx_s], negs, w_s, gen),
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
        raise RuntimeError("SASRec uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        u, items = self.eval_embeddings(params, users)
        return u @ items.T

    def eval_embeddings(self, params, users):
        h = self.encode(params, self._eval_seq[users])
        return h[:, -1, :], self.whole(params, "item_emb") * (self.hidden_units ** 0.5)
