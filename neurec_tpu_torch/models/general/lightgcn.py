"""LightGCN — K-layer linear propagation over the normalized interaction
graph (He et al., SIGIR 2020). Port of
``neurec_tpu/models/general/lightgcn.py``:

* propagation E^{k+1} = Â E^k for K layers, final embedding = mean over
  [E^0..E^K]; at gowalla scale Â lies above ``DENSE_LIMIT`` and each
  layer runs the plan SpMM kernel (K2), its backward K2 over Â^T;
* BPR loss sum(softplus(neg - pos)) + reg * l2(layer-0 rows of the batch),
  each term scaled by the instance weight;
* eval scores = propagated user rows @ propagated item table^T;
* ``graph_shard`` = auto | on | off: on a mesh, ``on_mesh`` keeps one row
  block of Â per 'data' rank (``ops/graph.py::maybe_shard``; ``auto`` only
  a graph above ``DENSE_LIMIT``) and each layer runs ``spmm_sharded``: K2
  over the block's plan, the blocks all-gathered.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.graph import build_norm_adjacency, maybe_shard, spmm, spmm_sharded
from neurec_tpu_torch.ops.initializers import glorot_uniform
from neurec_tpu_torch.ops.losses import l2_loss, log_loss


@register("LightGCN")
class LightGCN(Recommender):
    data_kind = "pairwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.learning_rate = float(config.get("lr", config.get("learning_rate", 0.01)))
        self.reg = float(config.get("reg", 1e-3))
        self.emb_dim = int(config.get("embed_size", 64))
        self.n_layers = int(config.get("n_layers", 3))
        self.adj_type = config.get("adj_type", "pre")
        self.adj = build_norm_adjacency(dataset.train_matrix, self.adj_type, device=self.device)
        self.graph_shard = str(config.get("graph_shard", "auto")).lower()
        self._adj_sharded = None

    def on_mesh(self, mesh):
        self._adj_sharded = maybe_shard(self.adj, mesh, self.graph_shard)

    def init_params(self, generator: torch.Generator):
        return {
            "user_emb": glorot_uniform(generator, (self.num_users, self.emb_dim)).to(self.device),
            "item_emb": glorot_uniform(generator, (self.num_items, self.emb_dim)).to(self.device),
        }

    def propagate(self, params):
        """K-layer propagation; returns (user_table, item_table)."""
        ego = torch.cat([self.whole(params, "user_emb"), self.whole(params, "item_emb")], dim=0)
        acc = ego
        h = ego
        for _ in range(self.n_layers):
            h = spmm(self.adj, h) if self._adj_sharded is None else spmm_sharded(self._adj_sharded, h)
            acc = acc + h
        final = acc / (self.n_layers + 1)
        return final[: self.num_users], final[self.num_users :]

    def loss(self, params, batch, weights):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        u_table, i_table = self.propagate(params)
        u = u_table[users]
        y = torch.sum(u * i_table[pos], dim=-1) - torch.sum(u * i_table[neg], dim=-1)
        mf_loss = torch.sum(log_loss(y) * weights)
        w = weights[:, None]
        emb_loss = self.reg * l2_loss(
            self.rows(params, "user_emb", users) * w,
            self.rows(params, "item_emb", pos) * w,
            self.rows(params, "item_emb", neg) * w,
        )
        return mf_loss + emb_loss

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
