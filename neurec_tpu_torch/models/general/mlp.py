"""MLP — neural CF with an MLP tower over the [u; i] concatenation.

Port of ``neurec_tpu/models/general/mlp.py`` (model/general_recommender/
MLP.py:56-72): score = sum(MLP([m_u; n_i])), pairwise or pointwise
training with ``reg_mlp`` L2 on the looked-up embeddings. The
full-catalogue ``predict`` runs the tower over item chunks of
``predict_chunk`` (4096): a 2,048-user batch against 4,096 items is a
(2048, 4096, 64) f32 tower input, ~2.1 GB.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.bridge import map_params
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.ops.towers import apply_dense_stack, init_dense_stack

_PREDICT_CHUNK = 4096


def tower_scores(tower, m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(B, C) sums of the tower over every pair of ``m`` (B, h) and ``n``
    (C, h): the input [m_b; n_c] of each pair, broadcast."""
    B, C = m.shape[0], n.shape[0]
    x = torch.cat([m[:, None, :].expand(B, C, m.shape[1]), n[None, :, :].expand(B, C, n.shape[1])], dim=-1)
    return torch.sum(apply_dense_stack(tower, x), dim=-1)


@register("MLP")
class MLP(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.layers = list(config.get("layers", [64, 32, 16]))
        self.reg_mlp = float(config.get("reg_mlp", 0.0))
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 4)))
        self.is_pairwise = bool(config.get("is_pairwise", True))
        self.loss_function = config.get("loss_function", "bpr")
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "pairwise" if self.is_pairwise else "pointwise"
        self.predict_chunk = _PREDICT_CHUNK

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        half = self.layers[0] // 2
        params = {
            "mlp_user": init(generator, (self.num_users, half)),
            "mlp_item": init(generator, (self.num_items, half)),
            "tower": init_dense_stack(generator, self.layers[0], self.layers),
        }
        return map_params(lambda t: t.to(self.device), params)

    def _forward(self, params, users, items):
        m = self.rows(params, "mlp_user", users)
        n = self.rows(params, "mlp_item", items)
        vec = apply_dense_stack(params["tower"], torch.cat([m, n], dim=-1))
        return torch.sum(vec, dim=-1), m, n

    def loss(self, params, batch, weights):
        users = batch["users"]
        w = weights[:, None]
        if self.is_pairwise:
            y_pos, m, n1 = self._forward(params, users, batch["pos_items"])
            y_neg, _, n2 = self._forward(params, users, batch["neg_items"])
            return pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights) + (
                self.reg_mlp * l2_loss(m * w, n2 * w, n1 * w))
        y, m, n = self._forward(params, users, batch["items"])
        return pointwise_loss(self.loss_function, batch["labels"], y, weights=weights) + (
            self.reg_mlp * l2_loss(m * w, n * w))

    def predict(self, params, users):
        """(B, num_items) full-catalogue scores, chunked over items."""
        m = self.rows(params, "mlp_user", users)
        n_all = self.whole(params, "mlp_item")
        return torch.cat([tower_scores(params["tower"], m, n_all[sl])
                          for sl in chunks(self.num_items, self.predict_chunk)], dim=1)
