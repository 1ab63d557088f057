"""Fossil — fusing similarity models with Markov chains (He & McAuley, ICDM 2016).

Port of ``neurec_tpu/models/sequential/fossil.py`` (model/sequential_
recommender/Fossil.py:55-115, util/data_generator.py:57-111):

* score = |set|^-alpha <sum_{j in set} P_j, Q_i>
        + <sum_t (eta_bias_t + eta_{u,t}) P_{recent_t}, Q_i> + b_i,
  the recent items most recent first (the eta index convention);
* a positive takes the user's set less the target (n - 1 items), a
  negative the whole set (n);
* lambda / gamma / reg_eta regularization (``regs``).

The evaluation is ``_affine_eval(coeff * sum P + short, Q, bias)``: K1 at
embedding_size + 1. The sum of P over the user's items is the product of
the users' dense 0/1 train rows with P, where the JAX package gathers the
padded rows.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.data.padded import build_padded_positives, dense_rows
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.parallel.mesh import whole_term


@register("Fossil")
class Fossil(SequentialMixin, Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.alpha = float(config.get("alpha", 0.5))
        regs = config.get("regs", [0.0, 0.0, 0.0])
        self.lambda_bilinear = float(regs[0])
        self.gamma_bilinear = float(regs[1])
        self.reg_eta = float(regs[2]) if len(regs) > 2 else 0.0
        self.high_order = int(config.get("high_order", 1))
        self.is_pairwise = bool(config.get("is_pairwise", False))
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "time_pairwise" if self.is_pairwise else "time_pointwise"
        padded = build_padded_positives(dataset.train_matrix)
        self._rows = torch.from_numpy(padded.items).long().to(self.device)  # pad == num_items: the zero row
        self._lens = torch.from_numpy(padded.lengths).to(self.device)
        self._setup_recent(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        d = self.embedding_size
        params = {"P": init(generator, (self.num_items, d)), "Q": init(generator, (self.num_items, d)),
                  "eta": init(generator, (self.num_users, self.high_order)),
                  "eta_bias": init(generator, (1, self.high_order)), "bias": torch.zeros((self.num_items,))}
        return {k: v.to(self.device) for k, v in params.items()}

    def _short_term(self, params, users, recents_mrf):
        """The recent items most recent first (B, H) -> (B, d) weighted sum."""
        eta = params["eta_bias"] + self.rows(params, "eta", users)   # (B, H)
        short_emb = self.rows_padded(params, "P", recents_mrf)       # (B, H, d)
        return torch.sum(eta[:, :, None] * short_emb, dim=1), short_emb

    def _score(self, params, p, num_idx, short, items):
        q = self.rows(params, "Q", items)
        coeff = torch.pow(torch.clamp(num_idx, min=1.0), -self.alpha)
        return coeff * torch.sum(p * q, dim=-1) + torch.sum(short * q, dim=-1) + params["bias"][items], q

    def _full_sum(self, params, users):
        """(sum of P over each user's train items (B, d), their count (B,)):
        the users' dense 0/1 rows times P, one product each way. (A gather
        of the (B, L_max, d) padded rows sends the pad slots' gradient to
        one row: ~8M atomic adds a step at ml-1m's 2,320-wide rows.)"""
        P = self.whole(params, "P")
        rows = dense_rows(self._rows[users], self.num_items).to(P.dtype)
        return rows @ P, self._lens[users].float()

    def loss(self, params, batch, weights):
        users = batch["users"]
        recents = torch.flip(batch["recent_items"].reshape(-1, self.high_order), dims=[1])
        full_sum, n = self._full_sum(params, users)
        short, short_emb = self._short_term(params, users, recents)
        w, w3 = weights[:, None], weights[:, None, None]
        eta_reg = self.reg_eta * (l2_loss(self.rows(params, "eta", users) * w)
                                  + whole_term(l2_loss(params["eta_bias"])))
        if self.is_pairwise:
            pos = batch["pos_items"]
            p_pos = full_sum - self.rows(params, "P", pos)
            y_pos, q1 = self._score(params, p_pos, n - 1.0, short, pos)
            y_neg, q2 = self._score(params, full_sum, n, short, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.lambda_bilinear * l2_loss(p_pos * w)
                    + self.gamma_bilinear * l2_loss(q2 * w, q1 * w, short_emb * w3) + eta_reg)
        items, labels = batch["items"], batch["labels"]
        p = full_sum - self.rows(params, "P", items) * labels[:, None]
        y, q = self._score(params, p, torch.where(labels > 0, n - 1.0, n), short, items)
        return (pointwise_loss(self.loss_function, labels, y, weights=weights)
                + self.lambda_bilinear * l2_loss(p * w)
                + self.gamma_bilinear * l2_loss(q * w, short_emb * w3) + eta_reg)

    def _user_vecs(self, params, users):
        full_sum, n = self._full_sum(params, users)
        short, _ = self._short_term(params, users, torch.flip(self._recent_items[users], dims=[1]))
        return torch.pow(torch.clamp(n, min=1.0), -self.alpha)[:, None] * full_sum + short

    def predict(self, params, users):
        return self._user_vecs(params, users) @ self.whole(params, "Q").T + params["bias"][None, :]

    def eval_embeddings(self, params, users):
        return self._affine_eval(self._user_vecs(params, users), self.whole(params, "Q"), params["bias"])
