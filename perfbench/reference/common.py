"""Plain PyTorch pieces of the references: the normalized bipartite
adjacency, its product with a feature table, Adam, the arithmetic of one
precision, and the judges of the program's outputs.

Nothing here imports the program. Every product goes through an
``Arith``: ``float64`` and ``float32`` compute in that type;
``tf32`` is the control, float32 whose products take their operands
rounded to TF32 (10 stored mantissa bits, to nearest, ties away from
zero), as the tensor cores' TF32 mode takes them, and add in float32.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa cut to TF32's 10 bits, to nearest,
    ties away from zero."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """An operand rounded to TF32, whose gradient is rounded to TF32 too:
    the backward's products then also take TF32-level operands."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Arith(NamedTuple):
    name: str  # "float64", "float32" or "tf32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an operand of a product."""
        x = x.to(self.dtype)
        return _TF32Operand.apply(x) if self.name == "tf32" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # a product of two TF32 operands is exact in float32, so float32's
        # matmul of the rounded operands is the TF32 product
        return self.op(a) @ self.op(b)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Row-wise dot products."""
        return torch.sum(self.op(a) * self.op(b), dim=-1)


class Graph(NamedTuple):
    """A normalized (U+I) x (U+I) adjacency as COO edges on a device."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor
    vals: torch.Tensor  # float64
    n_nodes: int
    num_users: int


def bipartite_graph(train, adj_type: str, device) -> Graph:
    """A = [[0, R], [R^T, 0]] from the train CSR R, normalized: ``pre``
    D^-1/2 A D^-1/2 (LightGCN), ``norm`` D^-1 (A + I) (NGCF), with D the
    row sums and rows of sum 0 left at 0."""
    U, I = train.shape
    n = U + I
    coo = train.tocoo()
    u = torch.from_numpy(coo.row.astype(np.int64)).to(device)
    i = torch.from_numpy(coo.col.astype(np.int64)).to(device) + U
    rows, cols = torch.cat([u, i]), torch.cat([i, u])
    if adj_type == "norm":
        loops = torch.arange(n, device=device)
        rows, cols = torch.cat([rows, loops]), torch.cat([cols, loops])
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    if adj_type == "pre":
        d = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
        vals = d[rows] * d[cols]
    elif adj_type == "norm":
        vals = 1.0 / deg[rows]
    else:
        raise ValueError("adj_type %r" % adj_type)
    return Graph(rows, cols, vals, n, U)


def spmm(graph: Graph, x: torch.Tensor, arith: Arith) -> torch.Tensor:
    """``A @ x``: each edge's value times its column's row, added into its
    row (differentiable in ``x``)."""
    src = arith.op(graph.vals)[:, None] * arith.op(x)[graph.cols]
    return torch.zeros((graph.n_nodes, x.shape[1]), dtype=src.dtype, device=x.device).index_add(0, graph.rows, src)


def leaves(tree, prefix=()):
    """``(path, tensor)`` of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for j, v in enumerate(tree):
            yield from leaves(v, prefix + (j,))
    else:
        yield prefix, tree


def unflatten(flat: dict):
    """The tree of dicts and lists whose ``leaves`` are ``flat``'s items."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        return [t[j] for j in range(len(t))] if t and all(isinstance(k, int) for k in t) else t
    return lists(root)


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root), its
    bias corrections ``1 - b^t`` taken in float32 from float32 ``b``, over
    the leaves of a tree; a leaf without a gradient does not move."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.mu: Dict[tuple, torch.Tensor] = {}
        self.nu: Dict[tuple, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[tuple, torch.Tensor], grads: Dict[tuple, Optional[torch.Tensor]]) -> None:
        self.t += 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.t))
        for path, p in params.items():
            g = grads.get(path)
            if g is None:
                continue
            mu = self.mu.setdefault(path, torch.zeros_like(p))
            nu = self.nu.setdefault(path, torch.zeros_like(p))
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            update = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            p.add_(update * -self.lr)


# -- judging the program's outputs ---------------------------------------------

def leaf_gaps(prog: Dict[tuple, float], ref: Dict[tuple, float], grad_ref: Dict[tuple, float]) -> Dict[tuple, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's (round-off alone moves them) are left out."""
    med_grad = statistics.median(grad_ref.values())
    kept = [p for p in ref if grad_ref[p] >= 1e-3 * med_grad]
    med = statistics.median(ref[p] for p in kept)
    return {p: abs(prog.get(p, 0.0) - ref[p]) / max(ref[p], med) for p in kept}


def judge_topk(ids: np.ndarray, ref_scores: torch.Tensor, masked: torch.Tensor,
               scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    """A block of the program's top-K lists against the reference's scores.

    ``ids`` (B, K) the program's ranked items, ``ref_scores`` (B, I) the
    reference's scores of every item, ``masked`` (B, I) True at the items a
    user has consumed, ``scores`` (B, K) the program's scores of its items,
    where it returns them. Each row's scale is its largest |score|.

    ``topk_gap``: the most by which the reference's score of the item at a
    rank lies below the reference's best score at that rank; an id that is
    out of range, repeated or consumed reads infinite.
    ``score_gap``: the most by which a returned score is off the
    reference's score of its item."""
    B, K = ids.shape
    n_items = ref_scores.shape[1]
    dev = ref_scores.device
    bad = (ids < 0) | (ids >= n_items)
    idx = torch.from_numpy(np.where(bad, 0, ids).astype(np.int64)).to(dev)
    sorted_ids = np.sort(ids, axis=1)
    dup = np.zeros_like(bad)
    dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    bad_rows = torch.from_numpy(bad.any(1) | dup.any(1)).to(dev)
    bad_rows |= masked.gather(1, idx).any(1)
    scale = ref_scores.abs().amax(1).clamp_min(1e-30)
    live = torch.where(masked, torch.full_like(ref_scores, -math.inf), ref_scores)
    best = torch.topk(live, K, dim=1).values
    got = ref_scores.gather(1, idx)
    gap = ((best - got) / scale[:, None]).clamp_min(0).amax(1)
    gap = torch.where(bad_rows, torch.full_like(gap, math.inf), gap)
    out = {"topk_gap": float(gap.max())}
    if scores is not None:
        s = torch.from_numpy(scores.astype(np.float64)).to(dev)
        out["score_gap"] = float(((s - got).abs() / scale[:, None]).amax())
    return out


def ranking_metrics(ids: np.ndarray, test_rows: List[np.ndarray], k: int) -> np.ndarray:
    """(users, 2) Recall@k and NDCG@k of each ranked list: hits over the
    test items; DCG over the ideal DCG of min(|test|, k) hits, gains
    1 / log2(rank + 1)."""
    gains = 1.0 / np.log2(np.arange(2, k + 2))
    out = np.zeros((len(ids), 2))
    for r, (row, truth) in enumerate(zip(ids, test_rows)):
        hits = np.isin(row[:k], truth)
        out[r, 0] = hits.sum() / max(len(truth), 1)
        idcg = gains[:min(len(truth), k)].sum()
        out[r, 1] = (hits * gains).sum() / idcg if idcg > 0 else 0.0
    return out
