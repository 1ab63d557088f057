"""ItemKNN — item-item neighbourhood recommender.

Port of ``neurec_tpu/models/general/itemknn.py`` (the reference's
model/general_recommender/ItemKNN.py: Compute_Similarity :216-547, the
recommender :549): column similarities of the rating matrix R with top-K
sparsification and shrinkage, ratings = R @ W.

Similarities (on the columns of R, ``ss`` the columns' sums of squares):

* cosine:     dot / (|i||j| + shrink + 1e-6)
* asymmetric: dot / (ss_i^a ss_j^(1-a) + shrink + 1e-6)
* adjusted:   cosine after removing each USER's mean rating
* pearson:    cosine after removing each ITEM's mean rating
* jaccard (tanimoto): dot / (ss_i + ss_j - dot + shrink + 1e-6)
* dice:       dot / (ss_i + ss_j + shrink + 1e-6)
* tversky:    dot / (dot + a(ss_i - dot) + b(ss_j - dot) + shrink + 1e-6)
* euclidean:  1 / (sqrt(ss_i + ss_j - 2 dot) + shrink + 1e-9), the
              self-distance zeroed (the self-similarity survives top-K, as
              in the reference; the evaluation masks train items)

Every other mode zeroes the self-similarity before the top-K.

R is never densified. For each block of ``knn_block`` query columns the
(U, Bc) slice of R is built on the device by a scatter from that block's
COO triples, and the (Bc, I) dot products with every column come from one
product of the sparse R^T (I, U) with that slice (the JAX package builds
every key slice and multiplies dense blocks; a dot of 0/1 ratings is an
exact integer in any order). The neighbour weights stay sparse, (I, K)
values and ids, and ``predict`` aggregates R_u @ W per user batch from
CSR-layout user rows (a (B, L_max) window of the flat rows, one (B, I + 1)
scatter, K column gathers): nothing (U, I)-sized exists. The aggregation
takes the original ratings (the reference's ``train_matrix.dot(W)``, :573),
the centred ones only enter the similarity.
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.topk import top_k


@register("ItemKNN")
class ItemKNN(Recommender):
    data_kind = "none"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.topK = int(config.get("neighbor", 5))
        self.shrink = float(config.get("shrink", 0))
        self.similarity = config.get("similarity", "cosine")
        self.asymmetric_alpha = float(config.get("asymmetric_alpha", 0.5))
        self.tversky_alpha = float(config.get("tversky_alpha", 1.0))
        self.tversky_beta = float(config.get("tversky_beta", 1.0))
        self.epochs = 0
        self.block = int(config.get("knn_block", 512))
        csr = dataset.train_matrix.tocsr()
        self._coo = csr.tocoo()
        lens = np.diff(csr.indptr)
        self._L_max = max(int(lens.max()) if len(lens) else 1, 1)
        nnz = max(int(csr.nnz), 1)
        self._flat_items = np.full(nnz, self.num_items, np.int32)
        self._flat_vals = np.zeros(nnz, np.float32)
        self._flat_items[: csr.nnz] = csr.indices
        self._flat_vals[: csr.nnz] = csr.data
        self._row_offsets = csr.indptr.astype(np.int32)

    # -- similarity ---------------------------------------------------------
    def _centered_edge_vals(self) -> np.ndarray:
        """Edge values after the mode's mean-centring (the similarity side
        only), in ``self._coo``'s order; the JAX package's host arithmetic."""
        coo, mode = self._coo, self.similarity
        vals = coo.data.astype(np.float32)
        if mode == "adjusted":
            cnt = np.maximum(np.bincount(coo.row, minlength=self.num_users), 1)
            mean = np.bincount(coo.row, weights=vals, minlength=self.num_users) / cnt
            return vals - mean[coo.row].astype(np.float32)
        if mode == "pearson":
            cnt = np.maximum(np.bincount(coo.col, minlength=self.num_items), 1)
            mean = np.bincount(coo.col, weights=vals, minlength=self.num_items) / cnt
            return vals - mean[coo.col].astype(np.float32)
        return vals

    def _similarity(self, dot, cols, ss, norms):
        """The mode's (Bc, I) similarity block from its dot products, the
        self-similarity handled; ``cols`` the block's global column ids."""
        mode, shrink = self.similarity, self.shrink
        ss_c, norms_c = ss[cols][:, None], norms[cols][:, None]
        is_self = cols[:, None] == torch.arange(self.num_items, device=dot.device)[None, :]
        if mode in ("cosine", "adjusted", "pearson"):
            sim = dot / (norms_c * norms[None, :] + shrink + 1e-6)
        elif mode == "asymmetric":
            a = self.asymmetric_alpha
            sim = dot / (torch.pow(ss_c, a) * torch.pow(ss[None, :], 1.0 - a) + shrink + 1e-6)
        elif mode in ("jaccard", "tanimoto"):
            sim = dot / (ss_c + ss[None, :] - dot + shrink + 1e-6)
        elif mode == "dice":
            sim = dot / (ss_c + ss[None, :] + shrink + 1e-6)
        elif mode == "tversky":
            a, b = self.tversky_alpha, self.tversky_beta
            sim = dot / (dot + a * (ss_c - dot) + b * (ss[None, :] - dot) + shrink + 1e-6)
        elif mode == "euclidean":
            dist_sq = torch.clamp(ss_c + ss[None, :] - 2.0 * dot, min=0.0)
            dist = torch.sqrt(torch.where(is_self, torch.zeros_like(dist_sq), dist_sq))
            return 1.0 / (dist + shrink + 1e-9)
        else:
            raise ValueError("unknown similarity '%s'" % mode)
        return torch.where(is_self, torch.zeros_like(sim), sim)

    def _compute_w(self):
        """(w_vals, w_idx), (I, K): the top-K similar items of each column."""
        I, U, Bc, dev = self.num_items, self.num_users, self.block, self.device
        K = min(self.topK, I)
        coo = self._coo
        cvals = self._centered_edge_vals()
        ss = torch.from_numpy(np.bincount(coo.col, weights=cvals.astype(np.float64) ** 2,
                                          minlength=I).astype(np.float32)).to(dev)
        norms = torch.sqrt(ss)
        # R^T (I, U), sparse, for the dot products; the block slices by column
        r_t = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([coo.col, coo.row]).astype(np.int64)),
            torch.from_numpy(cvals), (I, U), check_invariants=True).coalesce().to(dev)
        order = np.argsort(coo.col, kind="stable")
        col = torch.from_numpy(coo.col[order].astype(np.int64)).to(dev)
        row = torch.from_numpy(coo.row[order].astype(np.int64)).to(dev)
        val = torch.from_numpy(cvals[order]).to(dev)
        starts = np.searchsorted(coo.col[order], np.arange(0, I + Bc, Bc))
        w_vals, w_idx = [], []
        for b, lo in enumerate(range(0, I, Bc)):
            width = min(Bc, I - lo)
            s, e = int(starts[b]), int(starts[b + 1])
            x1 = torch.zeros(U * width, dtype=torch.float32, device=dev)
            x1.index_add_(0, row[s:e] * width + (col[s:e] - lo), val[s:e])
            dot = torch.sparse.mm(r_t, x1.view(U, width)).T  # (width, I)
            cols = torch.arange(lo, lo + width, device=dev)
            vals, ids = top_k(self._similarity(dot, cols, ss, norms).contiguous(), K)
            w_vals.append(vals)
            w_idx.append(ids)
        w_vals = torch.cat(w_vals)
        return torch.where(torch.isfinite(w_vals), w_vals, torch.zeros_like(w_vals)), torch.cat(w_idx).int()

    def init_params(self, generator: torch.Generator):
        w_vals, w_idx = self._compute_w()
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {"w_vals": w_vals, "w_idx": w_idx, "row_offsets": put(self._row_offsets),
                "flat_items": put(self._flat_items), "flat_vals": put(self._flat_vals)}

    def loss(self, params, batch, weights):
        raise RuntimeError("ItemKNN has no training loss")

    def predict(self, params, users):
        """ratings[u, c] = sum_k R[u, idx[c, k]] vals[c, k], per user batch."""
        off = params["row_offsets"].long()
        users = users.long()
        starts = off[users]
        lens = off[users + 1] - starts
        win = torch.arange(self._L_max, device=off.device)[None, :]
        valid = win < lens[:, None]                                      # (B, L_max)
        pos = torch.clamp(starts[:, None] + win, max=params["flat_items"].shape[0] - 1)
        row_it = torch.where(valid, params["flat_items"][pos].long(), self.num_items)
        row_v = torch.where(valid, params["flat_vals"][pos], torch.zeros((), device=off.device))
        ru = torch.zeros((users.shape[0], self.num_items + 1), dtype=torch.float32, device=off.device)
        ru = ru.scatter_add_(1, row_it, row_v)[:, : self.num_items]
        w_vals, w_idx = self.whole(params, "w_vals"), self.whole(params, "w_idx").long()
        scores = torch.zeros((users.shape[0], self.num_items), dtype=torch.float32, device=off.device)
        for k in range(w_idx.shape[1]):
            scores = scores + ru[:, w_idx[:, k]] * w_vals[None, :, k]
        return scores
