"""FPMC — factorized personalized Markov chains (Rendle et al., WWW 2010).

Port of ``neurec_tpu/models/sequential/fpmc.py`` (model/sequential_
recommender/FPMC.py:17-165): score(u, l, i) = <UI_u, IU_i> + <IL_i, LI_l>
with l the previous item; pairwise or pointwise time-order training,
reg_mf * l2(batch lookups). The evaluation scores the user's last train
item: ``[UI_u, LI_last] . [IU, IL]``, factorized for the evaluator (K1 at
2 x embedding_size).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss


@register("FPMC")
class FPMC(SequentialMixin, Recommender):
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
        params = {"UI": init(generator, (self.num_users, d)), "IU": init(generator, (self.num_items, d)),
                  "IL": init(generator, (self.num_items, d)), "LI": init(generator, (self.num_items, d))}
        return {k: v.to(self.device) for k, v in params.items()}

    def _score(self, params, users, recent, items):
        ui, iu = self.rows(params, "UI", users), self.rows(params, "IU", items)
        il, li = self.rows(params, "IL", items), self.rows(params, "LI", recent)
        return torch.sum(ui * iu, dim=-1) + torch.sum(il * li, dim=-1), (ui, iu, il, li)

    def loss(self, params, batch, weights):
        users = batch["users"]
        recent = batch["recent_items"].reshape(-1)  # high_order == 1
        w = weights[:, None]
        if self.is_pairwise:
            y_pos, (ui, iu1, il1, li) = self._score(params, users, recent, batch["pos_items"])
            y_neg, (_, iu2, il2, _) = self._score(params, users, recent, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.reg_mf * l2_loss(ui * w, iu1 * w, il1 * w, li * w, iu2 * w, il2 * w))
        y, (ui, iu, il, li) = self._score(params, users, recent, batch["items"])
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg_mf * l2_loss(ui * w, iu * w, il * w, li * w))

    def predict(self, params, users):
        last = self._recent_items[users, -1]
        return (self.rows(params, "UI", users) @ self.whole(params, "IU").T
                + self.rows(params, "LI", last) @ self.whole(params, "IL").T)

    def eval_embeddings(self, params, users):
        last = self._recent_items[users, -1]
        return (torch.cat([self.rows(params, "UI", users), self.rows(params, "LI", last)], dim=1),
                torch.cat([self.whole(params, "IU"), self.whole(params, "IL")], dim=1))
