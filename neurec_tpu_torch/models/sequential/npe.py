"""NPE — neural personalized embedding (Nguyen & Takasu, IJCAI 2018).

Port of ``neurec_tpu/models/sequential/npe.py`` (model/sequential_
recommender/NPE.py:56-66): score = <relu(UI_u), relu(IU_i)> +
<relu(IU_i), relu(sum of the recent IL embeddings)>; pointwise time-order
training, reg * l2(batch lookups) (the reference config's dropout is not
in its graph). The evaluation is ``(relu(UI_u) + relu(ctx), relu(IU))``:
K1 at embedding_size.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pointwise_loss


@register("NPE")
class NPE(SequentialMixin, Recommender):
    data_kind = "time_pointwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.reg = float(config.get("reg", 0.0))
        self.high_order = int(config.get("high_order", 3))
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self._setup_recent(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        d = self.embedding_size
        params = {"UI": init(generator, (self.num_users, d)), "IU": init(generator, (self.num_items, d)),
                  "IL": init(generator, (self.num_items, d))}
        return {k: v.to(self.device) for k, v in params.items()}

    def loss(self, params, batch, weights):
        recent = batch["recent_items"].reshape(-1, self.high_order)
        ui, iu = self.rows(params, "UI", batch["users"]), self.rows(params, "IU", batch["items"])
        li = self.rows(params, "IL", recent)  # (B, H, d)
        ctx = torch.sum(li, dim=1)
        y = torch.sum(torch.relu(ui) * torch.relu(iu) + torch.relu(iu) * torch.relu(ctx), dim=-1)
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg * l2_loss(ui * weights[:, None], iu * weights[:, None], li * weights[:, None, None]))

    def _left(self, params, users):
        ctx = torch.sum(self.rows(params, "IL", self._recent_items[users]), dim=1)
        return torch.relu(self.rows(params, "UI", users)) + torch.relu(ctx)

    def predict(self, params, users):
        return self._left(params, users) @ torch.relu(self.whole(params, "IU")).T

    def eval_embeddings(self, params, users):
        return self._left(params, users), torch.relu(self.whole(params, "IU"))
