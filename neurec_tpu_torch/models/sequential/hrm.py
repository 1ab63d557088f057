"""HRM — hierarchical representation model (Wang et al., SIGIR 2015).

Port of ``neurec_tpu/models/sequential/hrm.py`` (model/sequential_
recommender/HRM.py:54-85): the session representation pools (avg or max)
the last ``high_order`` item embeddings; the hybrid user representation
pools [user_emb, session]; score = <hybrid, item_emb>. Pointwise time-order
training, reg_mf * l2(batch lookups). The evaluation is ``(hybrid,
item_emb)``: K1 at embedding_size.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pointwise_loss


@register("HRM")
class HRM(SequentialMixin, Recommender):
    data_kind = "time_pointwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.reg_mf = float(config.get("reg_mf", 0.0))
        self.high_order = int(config.get("high_order", 2))
        self.session_agg = config.get("session_agg", "avg")
        self.pre_agg = config.get("pre_agg", "avg")
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self._setup_recent(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        params = {"user_emb": init(generator, (self.num_users, self.embedding_size)),
                  "item_emb": init(generator, (self.num_items, self.embedding_size))}
        return {k: v.to(self.device) for k, v in params.items()}

    def _hybrid(self, params, users, recent):
        """(B, d) hybrid user representation from (B, H) recent items."""
        u = self.rows(params, "user_emb", users)   # (B, d)
        r = self.rows(params, "item_emb", recent)  # (B, H, d)
        if self.high_order > 1:
            sess = torch.amax(r, dim=1) if self.session_agg == "max" else torch.mean(r, dim=1)
        else:
            sess = r[:, 0]
        pair = torch.stack([u, sess], dim=1)   # (B, 2, d)
        return (torch.amax(pair, dim=1) if self.pre_agg == "max" else torch.mean(pair, dim=1)), u, r

    def loss(self, params, batch, weights):
        recent = batch["recent_items"].reshape(-1, self.high_order)
        hybrid, u, r = self._hybrid(params, batch["users"], recent)
        q = self.rows(params, "item_emb", batch["items"])
        y = torch.sum(hybrid * q, dim=-1)
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg_mf * l2_loss(u * weights[:, None], r * weights[:, None, None], q * weights[:, None]))

    def predict(self, params, users):
        return self._hybrid(params, users, self._recent_items[users])[0] @ self.whole(params, "item_emb").T

    def eval_embeddings(self, params, users):
        return self._hybrid(params, users, self._recent_items[users])[0], self.whole(params, "item_emb")
