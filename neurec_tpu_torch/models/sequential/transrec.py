"""TransRec — translation-based recommendation (He et al., RecSys 2017).

Port of ``neurec_tpu/models/sequential/transrec.py`` (model/sequential_
recommender/TransRec.py): training score b_i - ||u + g + prev - i||^2
(squared, TransRec.py:69-79), evaluation score b_i - ||u + g + prev - i||_2
(TransRec.py:105-110); the reference's mismatch is kept, the ranking being
monotone in either. Pairwise or pointwise, reg_mf * l2(lookups + the
global embedding). ``predict`` takes ``||a||^2 + ||b||^2 - 2<a, b>``, one
product and no (B, I, d) tensor, and ranks on the predict tier.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.parallel.mesh import whole_term


@register("TransRec")
class TransRec(SequentialMixin, Recommender):
    high_order = 1

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.reg_mf = float(config.get("reg_mf", 0.0))
        self.is_pairwise = bool(config.get("is_pairwise", True))
        self.loss_function = config.get("loss_function", "bpr")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "time_pairwise" if self.is_pairwise else "time_pointwise"
        self._setup_recent(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        d = self.embedding_size
        params = {"user_emb": init(generator, (self.num_users, d)), "item_emb": init(generator, (self.num_items, d)),
                  "item_bias": init(generator, (self.num_items,)), "global_emb": init(generator, (1, d))}
        return {k: v.to(self.device) for k, v in params.items()}

    def _score(self, params, users, recent, items):
        u, prev = self.rows(params, "user_emb", users), self.rows(params, "item_emb", recent)
        q, b = self.rows(params, "item_emb", items), params["item_bias"][items]
        vec = u + params["global_emb"] + prev - q
        return b - torch.sum(torch.square(vec), dim=-1), (u, prev, q, b)

    def loss(self, params, batch, weights):
        users = batch["users"]
        recent = batch["recent_items"].reshape(-1)
        w = weights[:, None]
        if self.is_pairwise:
            y_pos, (u, prev, q1, b1) = self._score(params, users, recent, batch["pos_items"])
            y_neg, (_, _, q2, b2) = self._score(params, users, recent, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.reg_mf * (l2_loss(u * w, prev * w, q2 * w, q1 * w, b1 * weights, b2 * weights)
                                     + whole_term(l2_loss(params["global_emb"]))))
        y, (u, prev, q, b) = self._score(params, users, recent, batch["items"])
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg_mf * (l2_loss(u * w, prev * w, q * w, b * weights)
                                 + whole_term(l2_loss(params["global_emb"]))))

    def predict(self, params, users):
        last = self._recent_items[users, -1]
        pre = (self.rows(params, "user_emb", users) + params["global_emb"]
               + self.rows(params, "item_emb", last))  # (B, d)
        q = self.whole(params, "item_emb")
        sq = (torch.sum(torch.square(pre), dim=1, keepdim=True) + torch.sum(torch.square(q), dim=1)[None, :]
              - 2.0 * pre @ q.T)
        return params["item_bias"][None, :] - torch.sqrt(torch.clamp(sq, min=1e-12))
