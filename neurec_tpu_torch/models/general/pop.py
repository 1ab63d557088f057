"""Pop — item-popularity baseline (port of ``neurec_tpu/models/general/pop.py``,
model/general_recommender/Pop.py:5-31).

Scores every item by its training interaction count; no training. The
evaluator ranks it through K1 at d = 1 (a column of ones against the
counts); ties are many and the lowest item id wins them (``ops/topk.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register


@register("Pop")
class Pop(Recommender):
    data_kind = "none"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        counts = np.asarray((dataset.train_matrix != 0).sum(axis=0)).reshape(-1)
        self._scores = torch.from_numpy(counts.astype(np.float32)).to(self.device)
        self.epochs = 0

    def init_params(self, generator: torch.Generator):
        return {"item_count": self._scores.clone()}

    def loss(self, params, batch, weights):
        raise RuntimeError("Pop has no training loss")

    def predict(self, params, users):
        return params["item_count"][None, :].expand(users.shape[0], self.num_items)

    def eval_embeddings(self, params, users):
        ones = torch.ones((users.shape[0], 1), dtype=torch.float32, device=params["item_count"].device)
        return ones, params["item_count"][:, None].float()
