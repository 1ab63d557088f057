"""MF — matrix factorization (BPRMF / GMF family).

Port of ``neurec_tpu/models/general/mf.py`` (model/general_recommender/
MF.py:16-134): score(u, i) = <p_u, q_i>; pairwise (bpr/hinge/square on the
score difference) or pointwise (cross_entropy/square) training with
per-batch L2 regularization ``reg_mf * l2_loss(looked-up embeddings)``.
No SpMM: MF trains through the Trainer alone.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss


@register("MF")
class MF(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.reg_mf = float(config.get("reg_mf", 0.0))
        self.is_pairwise = bool(config.get("is_pairwise", True))
        self.loss_function = config.get("loss_function", "bpr")
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "pairwise" if self.is_pairwise else "pointwise"

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {
            "user_emb": init(generator, (self.num_users, self.embedding_size)).to(self.device),
            "item_emb": init(generator, (self.num_items, self.embedding_size)).to(self.device),
        }

    def _score(self, params, users, items):
        p = self.rows(params, "user_emb", users)
        q = self.rows(params, "item_emb", items)
        return torch.sum(p * q, dim=-1), p, q

    def loss(self, params, batch, weights):
        users = batch["users"]
        w = weights[:, None]
        if self.is_pairwise:
            y_pos, p, q_pos = self._score(params, users, batch["pos_items"])
            y_neg, _, q_neg = self._score(params, users, batch["neg_items"])
            loss = pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
            reg = self.reg_mf * l2_loss(p * w, q_neg * w, q_pos * w)
        else:
            y, p, q = self._score(params, users, batch["items"])
            loss = pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
            reg = self.reg_mf * l2_loss(p * w, q * w)
        return loss + reg

    def predict(self, params, users):
        return self.rows(params, "user_emb", users) @ self.whole(params, "item_emb").T

    def eval_embeddings(self, params, users):
        """Factorized eval form for the fused score+mask kernel."""
        return self.rows(params, "user_emb", users), self.whole(params, "item_emb")
