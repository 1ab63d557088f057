"""DiffNet — influence-diffusion social recommender (Wu et al., SIGIR 2019).

Port of ``neurec_tpu/models/social/diffnet.py`` (model/social_recommender/
DiffNet.py:20-225, as coded: the commented-out fusion layers reduce to
additions):

* item_final = item_embedding + convertDist(sigmoid(dense(convertDist(item
  features)))) when the item feature file holds a known item, else
  item_embedding;
* user_final = S(S(user_embedding)) + C(item_final), S the row-normalized
  symmetric social matrix (``social + social.T``) and C the row-normalized
  consumed-items matrix: three segment sums over row-sorted edges, each
  edge worth 1 / (the row's nonzero count);
* pointwise sigmoid cross-entropy (mean) over the Trainer's ``pointwise``
  epoch, plus reg_mf * l2(the batch's lookups). ``loss_function`` is
  cross_entropy whatever the conf says (the JAX package hard-sets it);
* evaluation: ``eval_tables`` (hoisted once per call) -> K1 at
  ``embedding_size``.

The segment sums are ``torch.segment_reduce`` over the edges' rows, one
ordered sum per output element (the same bits on every run on the card),
where the JAX package calls ``jax.ops.segment_sum``; the results agree to
f32 noise. ``convertDist`` takes the population variance, as ``jnp.var``.
Feature lines ``idx::::[v, ...]`` are parsed by ``ast.literal_eval`` where
the JAX package calls ``eval``: the same vectors for the list literals
such files hold.
"""

from __future__ import annotations

import ast
import os

import numpy as np
import torch

from neurec_tpu_torch.data.social import load_social_matrix
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pointwise_loss
from neurec_tpu_torch.ops.towers import init_dense_stack


def _row_normalized_coo(matrix):
    """CSR -> (rows, cols, vals) int32, int32, float32: the entries sorted
    stably by row, each worth 1 / (its row's nonzero count)."""
    coo = matrix.tocoo()
    row_nnz = np.asarray((matrix != 0).sum(axis=1)).ravel()
    vals = 1.0 / np.maximum(row_nnz[coo.row], 1)
    order = np.argsort(coo.row, kind="stable")
    return (coo.row[order].astype(np.int32), coo.col[order].astype(np.int32),
            vals[order].astype(np.float32))


def _convert_distribution(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    mean = torch.mean(x)
    var = torch.clamp(torch.var(x, correction=0), min=eps)
    return (x - mean) * 0.1 * torch.rsqrt(var)


def _load_features(path, id_map, num_rows: int, dim: int):
    vectors = np.zeros((num_rows, dim), dtype=np.float32)
    found = False
    if path and os.path.isfile(path):
        with open(path, "r") as f:
            for line in f:
                idx, data = line.strip().split("::::")
                for key in (idx, int(idx) if idx.isdigit() else idx):
                    if key in id_map:
                        vectors[id_map[key]] = ast.literal_eval(data)
                        found = True
                        break
    return vectors, found


class _Edges:
    """Row-sorted edges of a row-normalized matrix on the device."""

    def __init__(self, matrix, device):
        rows, cols, vals = _row_normalized_coo(matrix)
        self.cols = torch.from_numpy(cols).long().to(device)
        self.vals = torch.from_numpy(vals).to(device)
        self.lengths = torch.from_numpy(np.bincount(rows, minlength=matrix.shape[0])).to(device)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, d) = the matrix @ x, one ordered sum per output element.
        ``unsafe``: the lengths, a bincount of the edges' rows, are valid by
        construction, and the checks that it skips read them on the host (a
        CUDA graph cannot hold them)."""
        return torch.segment_reduce(x[self.cols] * self.vals[:, None].to(x.dtype), "sum",
                                    lengths=self.lengths, axis=0, unsafe=True)


@register("DiffNet")
class DiffNet(Recommender):
    data_kind = "pointwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.reg_mf = float(config.get("reg_mf", 1e-5))
        self.feature_dimension = int(config.get("feature_dimension", 150))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.loss_function = "cross_entropy"

        social = load_social_matrix(dataset, config)
        self.social_matrix = social + social.T
        self._soc_edges = _Edges(self.social_matrix, self.device)
        self._cons_edges = _Edges(dataset.train_matrix, self.device)

        user_feat, self._has_user_feat = _load_features(
            config.get("user_feature_file"), dataset.userids, self.num_users, self.feature_dimension)
        item_feat, self._has_item_feat = _load_features(
            config.get("item_feature_file"), dataset.itemids, self.num_items, self.feature_dimension)
        self._user_feat = torch.from_numpy(user_feat).to(self.device)
        self._item_feat = torch.from_numpy(item_feat).to(self.device)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {
            "user_emb": init(generator, (self.num_users, self.embedding_size)).to(self.device),
            "item_emb": init(generator, (self.num_items, self.embedding_size)).to(self.device),
            "reduce_dim": [{k: v.to(self.device) for k, v in layer.items()}
                           for layer in init_dense_stack(generator, self.feature_dimension, [self.embedding_size])],
        }

    def _tables(self, params):
        item_final = self.whole(params, "item_emb")
        if self._has_item_feat:
            layer = params["reduce_dim"][0]
            feat = _convert_distribution(self._item_feat).to(layer["w"].dtype)
            reduced = torch.sigmoid(feat @ layer["w"] + layer["b"])
            item_final = item_final + _convert_distribution(reduced)
        from_items = self._cons_edges.spmm(item_final)
        gcn1 = self._soc_edges.spmm(self.whole(params, "user_emb"))
        gcn2 = self._soc_edges.spmm(gcn1)
        return gcn2 + from_items, item_final

    def loss(self, params, batch, weights):
        u_table, i_table = self._tables(params)
        u = u_table[batch["users"]]
        q = i_table[batch["items"]]
        y = torch.sum(u * q, dim=-1)
        w = weights[:, None]
        return pointwise_loss(self.loss_function, batch["labels"], y, weights=weights) + self.reg_mf * l2_loss(
            u * w, q * w)

    def predict(self, params, users):
        u_table, i_table = self._tables(params)
        return u_table[users] @ i_table.T

    def eval_embeddings(self, params, users):
        u_table, i_table = self._tables(params)
        return u_table[users], i_table

    def eval_tables(self, params):
        """User-independent tables, computed once per evaluation."""
        return self._tables(params)
