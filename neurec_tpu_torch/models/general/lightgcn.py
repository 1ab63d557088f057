"""LightGCN — K-layer linear propagation over the normalized interaction
graph (He et al., SIGIR 2020). Port of
``neurec_tpu/models/general/lightgcn.py`` for serving and evaluation:

* propagation E^{k+1} = Â E^k for K layers, final embedding = mean over
  [E^0..E^K]; at gowalla scale Â lies above ``DENSE_LIMIT`` and each
  layer runs the plan SpMM kernel (K2);
* eval scores = propagated user rows @ propagated item table^T.

Training (the BPR loss and the SpMM backward) comes with a later slice.
"""

from __future__ import annotations

import math

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.graph import build_norm_adjacency, spmm


def glorot_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)) with fan_in = rows and
    fan_out = columns — ``jax.nn.initializers.glorot_uniform`` on 2-D."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


@register("LightGCN")
class LightGCN(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.emb_dim = int(config.get("embed_size", 64))
        self.n_layers = int(config.get("n_layers", 3))
        self.adj_type = config.get("adj_type", "pre")
        self.adj = build_norm_adjacency(dataset.train_matrix, self.adj_type, device=self.device)

    def init_params(self, generator: torch.Generator):
        return {
            "user_emb": glorot_uniform((self.num_users, self.emb_dim), generator).to(self.device),
            "item_emb": glorot_uniform((self.num_items, self.emb_dim), generator).to(self.device),
        }

    def propagate(self, params):
        """K-layer propagation; returns (user_table, item_table)."""
        ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0)
        acc = ego
        h = ego
        for _ in range(self.n_layers):
            h = spmm(self.adj, h)
            acc = acc + h
        final = acc / (self.n_layers + 1)
        return final[: self.num_users], final[self.num_users :]

    def predict(self, params, users):
        u_table, i_table = self.propagate(params)
        return u_table[users] @ i_table.T

    def eval_embeddings(self, params, users):
        """Factorized eval form for the fused score+mask kernel."""
        u_table, i_table = self.propagate(params)
        return u_table[users], i_table

    def eval_tables(self, params):
        """User-independent tables: the evaluator computes the K-layer
        propagation once per call instead of once per batch."""
        return self.propagate(params)
