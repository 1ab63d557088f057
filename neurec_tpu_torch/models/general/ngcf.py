"""NGCF — neural graph collaborative filtering (Wang et al., SIGIR 2019).

Port of ``neurec_tpu/models/general/ngcf.py``:

* adjacency plain / norm (D^-1(A+I), the default) / gcmc (D^-1 A) / mean
  fallback over the bipartite graph; at gowalla scale it lies above
  ``DENSE_LIMIT`` and each layer runs the plan SpMM (K2, or K3 under
  ``NEUREC_SPMM_PACK``), its backward over the plan of A^T — a plan of
  another structure, since ``norm`` is not symmetric;
* three propagation variants:
  - ngcf: leaky_relu(Â E W_gc + b_gc) + leaky_relu((E ⊙ Â E) W_bi + b_bi),
    message dropout, per-layer L2 normalization, concatenation of all layers;
  - gcn:  leaky_relu(Â E W_gc + b_gc), dropout, concatenation;
  - gcmc: an extra per-layer dense W_mlp, the layer-0 embedding left out;
  leaky_relu at slope 0.01 (``jax.nn.leaky_relu``);
* node and message dropout only while training, drawn from
  ``batch["generator"]`` (the trainer's per-step generator); node dropout
  replaces the edge values, so its steps leave the kernel for the
  segment-sum path (``graph.with_vals``), as in the JAX package;
* BPR loss sum(softplus(neg - pos)) + reg * l2(propagated batch rows),
  each term scaled by the instance weight;
* ``pretrain_file``: a ``[user_emb, item_emb]`` pickle warm-starts the
  embeddings;
* ``graph_shard`` = auto | on | off, as LightGCN's: on a mesh each 'data'
  rank keeps one row block of Â and each layer runs ``spmm_sharded``; node
  dropout on a block draws over every block's padded edges (the same draw
  on every rank), keeps the rank's, and takes the segment-sum branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.activations import l2_normalize
from neurec_tpu_torch.ops.graph import (
    SparseAdj, build_norm_adjacency, maybe_shard, spmm, spmm_sharded, with_vals,
)
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, log_loss
from neurec_tpu_torch.pretrain import try_load

_SLOPE = 0.01  # jax.nn.leaky_relu's default


def _keep_mask(generator: torch.Generator, shape, keep: float, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device) < keep


@register("NGCF")
class NGCF(Recommender):
    data_kind = "pairwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.emb_dim = int(config.get("embedding_size", 16))
        self.weight_size = list(config.get("layer_size", [16, 16]))
        self.n_layers = len(self.weight_size)
        self.reg = float(config.get("reg", 0.0))
        self.adj_type = config.get("adj_type", "norm")
        self.alg_type = config.get("alg_type", "ngcf")
        if self.alg_type not in ("ngcf", "gcn", "gcmc"):
            raise ValueError("alg_type %r" % self.alg_type)
        self.node_dropout_flag = bool(config.get("node_dropout_flag", False))
        self.node_dropout_ratio = float(config.get("node_dropout_ratio", 0.1))
        self.mess_dropout_ratio = float(config.get("mess_dropout_ratio", 0.1))
        self.embed_init_method = config.get("embed_init_method", "xavier_normal")
        self.weight_init_method = config.get("weight_init_method", "xavier_normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.pretrain_file = config.get("pretrain_file", "")
        self.adj = build_norm_adjacency(dataset.train_matrix, self.adj_type, device=self.device)
        self.graph_shard = str(config.get("graph_shard", "auto")).lower()
        self._adj_sharded = None

    def on_mesh(self, mesh):
        self._adj_sharded = maybe_shard(self.adj, mesh, self.graph_shard)

    def init_params(self, generator: torch.Generator):
        e_init = get_initializer(self.embed_init_method, self.stddev)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        params = {
            "user_emb": e_init(generator, (self.num_users, self.emb_dim)),
            "item_emb": e_init(generator, (self.num_items, self.emb_dim)),
            "W_gc": [], "b_gc": [], "W_bi": [], "b_bi": [], "W_mlp": [], "b_mlp": [],
        }
        dims = [self.emb_dim] + self.weight_size
        for k in range(self.n_layers):
            for name, shape in (("W_gc", (dims[k], dims[k + 1])), ("b_gc", (1, dims[k + 1])),
                                ("W_bi", (dims[k], dims[k + 1])), ("b_bi", (1, dims[k + 1])),
                                ("W_mlp", (dims[k], dims[k + 1])), ("b_mlp", (1, dims[k + 1]))):
                params[name].append(w_init(generator, shape))
        loaded = try_load(self.pretrain_file)
        if loaded is not None:
            params["user_emb"] = torch.as_tensor(loaded[0][0], dtype=torch.float32)
            params["item_emb"] = torch.as_tensor(loaded[0][1], dtype=torch.float32)
        return {name: [v.to(self.device) for v in value] if isinstance(value, list) else value.to(self.device)
                for name, value in params.items()}

    def _adj_for_step(self, generator, training: bool):
        """The adjacency of one step (a ``SparseAdj``, or this rank's
        ``ShardedAdj`` block): with edge dropout while training."""
        adj = self.adj if self._adj_sharded is None else self._adj_sharded
        if not (training and self.node_dropout_flag and generator is not None):
            return adj
        keep = 1.0 - self.node_dropout_ratio
        if not isinstance(adj, SparseAdj):
            # every block's padded edges drawn at once, as the JAX package's
            # (n_blocks, E_pad) values; this rank keeps its block's row
            mask = _keep_mask(generator, (adj.n_blocks, adj.vals.shape[0]), keep, adj.vals.device)[adj.index]
            return adj._replace(vals=torch.where(mask, adj.vals / keep, torch.zeros_like(adj.vals)),
                                plan=None, plan_t=None)
        if adj.dense is not None:
            # zero entries stay zero: an element-wise mask is per-edge dropout
            mask = _keep_mask(generator, adj.dense.shape, keep, adj.dense.device)
            return adj._replace(dense=torch.where(mask, adj.dense / keep, torch.zeros_like(adj.dense)))
        mask = _keep_mask(generator, adj.vals.shape, keep, adj.vals.device)
        return with_vals(adj, torch.where(mask, adj.vals / keep, torch.zeros_like(adj.vals)))

    def _mess_dropout(self, x, generator, training: bool):
        if not training or generator is None or self.mess_dropout_ratio <= 0:
            return x
        keep = 1.0 - self.mess_dropout_ratio
        mask = _keep_mask(generator, x.shape, keep, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def propagate(self, params, generator=None, training: bool = False):
        """Returns (user_table, item_table), the concatenated layers."""
        adj = self._adj_for_step(generator, training)
        ego = torch.cat([self.whole(params, "user_emb"), self.whole(params, "item_emb")], dim=0)
        outs = [] if self.alg_type == "gcmc" else [ego]
        h = ego
        for k in range(self.n_layers):
            side = spmm(adj, h) if isinstance(adj, SparseAdj) else spmm_sharded(adj, h)
            if self.alg_type == "ngcf":
                sum_emb = F.leaky_relu(side @ params["W_gc"][k] + params["b_gc"][k], _SLOPE)
                bi = F.leaky_relu((h * side) @ params["W_bi"][k] + params["b_bi"][k], _SLOPE)
                h = self._mess_dropout(sum_emb + bi, generator, training)
                outs.append(l2_normalize(h, dim=1))
            elif self.alg_type == "gcn":
                h = F.leaky_relu(side @ params["W_gc"][k] + params["b_gc"][k], _SLOPE)
                h = self._mess_dropout(h, generator, training)
                outs.append(h)
            else:  # gcmc
                h = F.leaky_relu(side @ params["W_gc"][k] + params["b_gc"][k], _SLOPE)
                mlp = h @ params["W_mlp"][k] + params["b_mlp"][k]
                outs.append(self._mess_dropout(mlp, generator, training))
        all_emb = torch.cat(outs, dim=1)
        return all_emb[: self.num_users], all_emb[self.num_users:]

    def loss(self, params, batch, weights):
        u_table, i_table = self.propagate(params, batch.get("generator"), training=True)
        u = u_table[batch["users"]]
        pi = i_table[batch["pos_items"]]
        ni = i_table[batch["neg_items"]]
        y = torch.sum(u * pi, dim=-1) - torch.sum(u * ni, dim=-1)
        mf_loss = torch.sum(log_loss(y) * weights)
        w = weights[:, None]
        return mf_loss + self.reg * l2_loss(u * w, pi * w, ni * w)

    def predict(self, params, users):
        u_table, i_table = self.propagate(params)
        return u_table[users] @ i_table.T

    def eval_embeddings(self, params, users):
        """Factorized eval form for the fused score+mask kernel (K1, at the
        concatenated width)."""
        u_table, i_table = self.propagate(params)
        return u_table[users], i_table

    def eval_tables(self, params):
        """User-independent tables, hoisted out of the eval batches."""
        return self.propagate(params)
