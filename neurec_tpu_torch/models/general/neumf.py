"""NeuMF — neural collaborative filtering (GMF element product + MLP tower).

Port of ``neurec_tpu/models/general/neumf.py`` (model/general_recommender/
NeuMF.py:16-169): score = sum(p_u * q_i) + sum(MLP([m_u; n_i])), with no
output projection (the raw sum, as the reference). Pairwise or pointwise
training with separate ``reg_mf`` / ``reg_mlp`` L2 on the looked-up
embeddings. ``mf_pretrain`` / ``mlp_pretrain``: pickled ``[user, item]``
pairs (``pretrain.save_pretrain``'s "MF" and "MLP" layouts) warm-start the
four tables. ``predict`` runs over item chunks of ``predict_chunk``
(4096), as the JAX package's scan does.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.bridge import map_params
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.models.general.mlp import _PREDICT_CHUNK, tower_scores
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.ops.towers import apply_dense_stack, init_dense_stack
from neurec_tpu_torch.pretrain import as_tensor, try_load


@register("NeuMF")
class NeuMF(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.layers = list(config.get("layers", [64, 32, 16]))
        self.reg_mf = float(config.get("reg_mf", 0.0))
        self.reg_mlp = float(config.get("reg_mlp", 0.0))
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 4)))
        self.is_pairwise = bool(config.get("is_pairwise", False))
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.mf_pretrain = config.get("mf_pretrain", "")
        self.mlp_pretrain = config.get("mlp_pretrain", "")
        self.data_kind = "pairwise" if self.is_pairwise else "pointwise"
        self.predict_chunk = _PREDICT_CHUNK

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        half = self.layers[0] // 2
        params = {
            "mf_user": init(generator, (self.num_users, self.embedding_size)),
            "mf_item": init(generator, (self.num_items, self.embedding_size)),
            "mlp_user": init(generator, (self.num_users, half)),
            "mlp_item": init(generator, (self.num_items, half)),
            "tower": init_dense_stack(generator, self.layers[0], self.layers),
        }
        loaded = try_load(self.mf_pretrain, self.mlp_pretrain)
        if loaded is not None:
            mf, mlp = loaded
            params["mf_user"], params["mf_item"] = as_tensor(mf[0], self.device), as_tensor(mf[1], self.device)
            params["mlp_user"], params["mlp_item"] = as_tensor(mlp[0], self.device), as_tensor(mlp[1], self.device)
        return map_params(lambda t: t.to(self.device), params)

    def _forward(self, params, users, items):
        """Scores of (user, item) pairs and the looked-up embeddings."""
        p = self.rows(params, "mf_user", users)
        q = self.rows(params, "mf_item", items)
        m = self.rows(params, "mlp_user", users)
        n = self.rows(params, "mlp_item", items)
        mlp_vec = apply_dense_stack(params["tower"], torch.cat([m, n], dim=-1))
        return torch.sum(p * q, dim=-1) + torch.sum(mlp_vec, dim=-1), (p, q, m, n)

    def loss(self, params, batch, weights):
        users = batch["users"]
        w = weights[:, None]
        if self.is_pairwise:
            y_pos, (p, q1, m, n1) = self._forward(params, users, batch["pos_items"])
            y_neg, (_, q2, _, n2) = self._forward(params, users, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.reg_mf * l2_loss(p * w, q2 * w, q1 * w)
                    + self.reg_mlp * l2_loss(m * w, n2 * w, n1 * w))
        y, (p, q, m, n) = self._forward(params, users, batch["items"])
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg_mf * l2_loss(p * w, q * w)
                + self.reg_mlp * l2_loss(m * w, n * w))

    def predict(self, params, users):
        """(B, num_items) full-catalogue scores, chunked over items."""
        p = self.rows(params, "mf_user", users)
        m = self.rows(params, "mlp_user", users)
        q_all, n_all = self.whole(params, "mf_item"), self.whole(params, "mlp_item")
        return torch.cat([p @ q_all[sl].T + tower_scores(params["tower"], m, n_all[sl])
                          for sl in chunks(self.num_items, self.predict_chunk)], dim=1)
