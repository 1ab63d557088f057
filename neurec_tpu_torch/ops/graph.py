"""Graph ops: normalized bipartite adjacency + SpMM.

Port of ``neurec_tpu/ops/graph.py`` (single device). Nodes 0..U-1 are
users, U..U+I-1 items; A = [[0, R], [R^T, 0]]. Normalizations:

* plain: A
* norm:  D^-1 (A + I)
* gcmc:  D^-1 A
* pre:   D^-1/2 A D^-1/2
* (anything else): D^-1 A + I   — the reference's fallback "mean" adjacency

``spmm`` has the JAX package's three branches: a dense matmul below
``DENSE_LIMIT`` entries, the plan SpMM above it (``ops/spmm.py``: K2, or
K3 under ``NEUREC_SPMM_PACK``, in the dtype ``NEUREC_SPMM_DTYPE`` gives),
and the sorted COO segment-sum (``index_add_``) when a graph carries
neither — as after ``with_vals`` (node dropout) — or when
``NEUREC_SPMM_PALLAS=0`` turns the plan kernels off (read at each call,
as the JAX package's ``_pallas_spmm_enabled``; the segment sum runs on
the graph's device, so it is no CPU fallback). The plan branch is
differentiable through ``PlanSpmm``, whose backward runs the same routing
over the transposed plan (``neurec_tpu/ops/pallas_spmm.py`` ``make_spmm``);
the other two keep autograd's own gradient, as JAX's ``jnp.dot`` and
``segment_sum`` do.

On a mesh (``neurec_tpu/ops/graph.py:183-449``): ``shard_adjacency`` keeps
one row block of the adjacency per 'data' rank, with its own K2 plans, and
``spmm_sharded`` computes the rank's output rows and all-gathers them
(``ShardedAdj``, ``maybe_shard``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.ops import spmm as spmm_ops
from neurec_tpu_torch.parallel.mesh import Mesh, all_gather_rows, axis_size, reduce_scatter_rows


class SparseAdj(NamedTuple):
    """Adjacency on a device: padded COO edges, plus a dense copy below
    ``DENSE_LIMIT`` entries or the SpMM plans of A and A^T above it."""

    rows: torch.Tensor  # (nnz_pad,) int32, sorted, pads repeat the last row
    cols: torch.Tensor  # (nnz_pad,) int32
    vals: torch.Tensor  # (nnz_pad,) float32, 0.0 on padding
    n_nodes: int
    dense: Optional[torch.Tensor] = None  # (n_nodes, n_nodes) f32 or None
    plan: Optional[spmm_ops.SpmmPlan] = None
    plan_t: Optional[spmm_ops.SpmmPlan] = None  # A^T, for the backward


# dense adjacency cutoff: 64M f32 entries == 256 MB
DENSE_LIMIT = 64 * 1024 * 1024


def _normalize(adj_mat: sp.spmatrix, adj_type: str) -> sp.coo_matrix:
    def normalized_adj_single(adj):
        rowsum = np.array(adj.sum(1))
        # entries where rowsum == 0 are left uninitialized by ``where`` and
        # zeroed only if non-finite — kept exactly as the reference has it
        d_inv = np.power(rowsum, -1.0, where=rowsum > 0).flatten()
        d_inv[~np.isfinite(d_inv)] = 0.0
        return sp.diags(d_inv).dot(adj).tocoo()

    if adj_type == "plain":
        return adj_mat.tocoo()
    elif adj_type == "norm":
        return normalized_adj_single(adj_mat + sp.eye(adj_mat.shape[0]))
    elif adj_type == "gcmc":
        return normalized_adj_single(adj_mat)
    elif adj_type == "pre":
        rowsum = np.array(adj_mat.sum(1))
        d_inv = np.power(rowsum, -0.5, where=rowsum > 0).flatten()
        d_inv[~np.isfinite(d_inv)] = 0.0
        d_mat_inv = sp.diags(d_inv)
        return d_mat_inv.dot(adj_mat).dot(d_mat_inv).tocoo()
    else:  # reference fallback: mean adjacency + self loops
        mean_adj = normalized_adj_single(adj_mat)
        return (mean_adj + sp.eye(mean_adj.shape[0])).tocoo()


def build_norm_adjacency(
    train_matrix: sp.csr_matrix,
    adj_type: str = "pre",
    pad_multiple: int = 1024,
    self_loops: bool = False,
    device: DeviceLike = None,
) -> SparseAdj:
    """Bipartite (U+I)x(U+I) adjacency from the train matrix, normalized,
    built on the host and placed on ``device``. ``self_loops`` adds I
    before the normalization. The plans' geometry comes from
    ``NEUREC_SPMM_TILE`` / ``NEUREC_SPMM_CHUNK`` at build time; their
    schedules (``spmm_ops.spmm_schedule``) are built here too."""
    dev = resolve_device(device)
    num_users, num_items = train_matrix.shape
    coo = train_matrix.tocoo()
    n_nodes = num_users + num_items
    ratings = np.ones(coo.nnz, dtype=np.float32)
    tmp = sp.csr_matrix((ratings, (coo.row, coo.col + num_users)), shape=(n_nodes, n_nodes))
    adj_mat = tmp + tmp.T
    if self_loops:
        adj_mat = adj_mat + sp.eye(n_nodes)
    norm = _normalize(adj_mat, adj_type)

    nnz = norm.nnz
    nnz_pad = ((nnz + pad_multiple - 1) // pad_multiple) * pad_multiple
    rows = np.zeros(nnz_pad, dtype=np.int32)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    vals = np.zeros(nnz_pad, dtype=np.float32)
    order = np.argsort(norm.row, kind="stable")
    rows[:nnz] = norm.row[order]
    cols[:nnz] = norm.col[order]
    vals[:nnz] = norm.data[order]
    # pad edges carry value 0 and repeat the LAST real row, keeping the row
    # sequence sorted (row-0 pads would break it)
    if nnz:
        rows[nnz:] = rows[nnz - 1]
    dense = plan = plan_t = None
    if n_nodes * n_nodes <= DENSE_LIMIT:
        dense = torch.from_numpy(norm.toarray().astype(np.float32)).to(dev)
    else:
        plan = spmm_ops.build_spmm_plan(rows, cols, vals, n_nodes).to(dev)
        plan_t = spmm_ops.build_spmm_plan(cols, rows, vals, n_nodes)._replace(transposed=True).to(dev)
        for p in (plan, plan_t):  # the kernels' schedules, with the rest of the set-up
            spmm_ops.spmm_schedule(p)
    return SparseAdj(
        rows=torch.from_numpy(rows).to(dev),
        cols=torch.from_numpy(cols).to(dev),
        vals=torch.from_numpy(vals).to(dev),
        n_nodes=n_nodes,
        dense=dense,
        plan=plan,
        plan_t=plan_t,
    )


def with_vals(adj: SparseAdj, vals: torch.Tensor) -> SparseAdj:
    """The adjacency with its edge values replaced (NGCF's node dropout).
    The plans bake the values at build time, so they are dropped and
    ``spmm`` takes the segment-sum path, as ``neurec_tpu``'s NGCF routes it."""
    return adj._replace(vals=vals, plan=None, plan_t=None)


class PlanSpmm(torch.autograd.Function):
    """x -> A @ x over ``plan``, with d/dx = A^T @ g over ``plan_t``, as the
    JAX package's ``make_spmm`` custom VJP: x (forward) and the incoming
    gradient (backward) are cast to ``compute_dtype`` (None: f32) before
    the gather (``NEUREC_SPMM_DTYPE``), and ``plan_spmm`` picks K2 or K3. The adjacency values are
    not trained, so only x gets a gradient.

    ``spmm_ops.plan_spmm`` is looked up at each call, so that replacing it
    (with its plain version, say) reaches the backward too.
    """

    @staticmethod
    def forward(ctx, x, plan, plan_t, compute_dtype=None):
        ctx.plan_t, ctx.compute_dtype = plan_t, compute_dtype
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return spmm_ops.plan_spmm(plan, x)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.plan_t is None:
            raise ValueError("the adjacency carries no transposed plan for the backward")
        # the gradient of a row slice of the output may arrive non-contiguous
        g = grad_out.contiguous()
        if ctx.compute_dtype is not None:
            g = g.to(ctx.compute_dtype)
        return spmm_ops.plan_spmm(ctx.plan_t, g), None, None, None


def plan_kernels_enabled() -> bool:
    """False under ``NEUREC_SPMM_PALLAS=0``: ``spmm`` and ``spmm_sharded``
    then take the segment sum over a graph that has plans. The JAX
    package's ``NEUREC_PALLAS_INTERPRET`` has no counterpart here."""
    import os

    return os.environ.get("NEUREC_SPMM_PALLAS", "auto") != "0"


def spmm(adj: SparseAdj, x: torch.Tensor) -> torch.Tensor:
    """(n_nodes x n_nodes) adjacency @ dense (n_nodes, d), in f32."""
    if adj.dense is not None:
        return torch.matmul(adj.dense, x)
    if adj.plan is not None and plan_kernels_enabled():
        return PlanSpmm.apply(x, adj.plan, adj.plan_t, spmm_ops.spmm_compute_dtype())
    gathered = x[adj.cols.long()] * adj.vals[:, None]
    out = torch.zeros((adj.n_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, adj.rows.long(), gathered)


class ShardedAdj(NamedTuple):
    """One 'data' rank's row block of a ``SparseAdj``.

    Block b owns the global rows ``[b*block, (b+1)*block)``, ``block =
    ceil(n_nodes / n_blocks)``; this rank holds block ``index``: its edges
    in the global row-sorted order, as ``rows_local`` (the row minus the
    block's start), ``cols`` (global source ids) and ``vals``, padded to
    ``e_pad`` (the largest block's edge count rounded up, equal on every
    rank) with value-0 edges repeating the last row. ``plan`` is the
    block's K2 plan (block-local destination rows, global source columns,
    ``n_rows = block``); ``plan_t`` its transpose for the backward (A_b^T:
    destination rows the global columns, ``n_rows = n_nodes``). Both None
    after a change of values (NGCF's node dropout): ``spmm_sharded`` then
    takes the segment-sum branch.
    """

    rows_local: torch.Tensor  # (e_pad,) int32, sorted
    cols: torch.Tensor        # (e_pad,) int32
    vals: torch.Tensor        # (e_pad,) float32, 0.0 on padding
    n_nodes: int
    block: int
    n_blocks: int
    index: int
    mesh: Mesh
    plan: Optional[spmm_ops.SpmmPlan] = None
    plan_t: Optional[spmm_ops.SpmmPlan] = None


def shard_adjacency(adj: SparseAdj, mesh: Mesh, pad_multiple: int = 1024, with_plans: bool = True) -> ShardedAdj:
    """This rank's row block of ``adj`` over the mesh's 'data' axis
    (``neurec_tpu/ops/graph.py:240-297``), on ``adj``'s device.
    ``with_plans`` also builds the block's K2 plans with the port's
    ``build_spmm_plan`` (geometry from ``NEUREC_SPMM_TILE`` /
    ``NEUREC_SPMM_CHUNK``) and their edge-balanced schedules."""
    n = axis_size(mesh, "data")
    b = mesh.coordinate["data"]
    dev = adj.rows.device
    rows, cols, vals = (t.cpu().numpy() for t in (adj.rows, adj.cols, adj.vals))
    keep = vals != 0.0  # the build's padding goes; each block re-pads below
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    block = -(-adj.n_nodes // n)
    owner = rows // block
    counts = np.bincount(owner, minlength=n)
    e_pad = max(int(-(-counts.max() // pad_multiple) * pad_multiple), pad_multiple)
    sel = owner == b  # keeps the global row-sorted order within the block
    k = int(counts[b])
    r_l = np.zeros(e_pad, dtype=np.int32)
    c = np.zeros(e_pad, dtype=np.int32)
    v = np.zeros(e_pad, dtype=np.float32)
    r_l[:k] = rows[sel] - b * block
    c[:k] = cols[sel]
    v[:k] = vals[sel]
    if k:  # keep the block's row sequence non-decreasing
        r_l[k:] = r_l[k - 1]
    plan = plan_t = None
    if with_plans:
        plan = spmm_ops.build_spmm_plan(r_l[:k], c[:k], v[:k], block).to(dev)
        plan_t = spmm_ops.build_spmm_plan(c[:k], r_l[:k], v[:k], adj.n_nodes)._replace(transposed=True).to(dev)
        for p in (plan, plan_t):
            spmm_ops.spmm_schedule(p)
    return ShardedAdj(
        rows_local=torch.from_numpy(r_l).to(dev), cols=torch.from_numpy(c).to(dev),
        vals=torch.from_numpy(v).to(dev), n_nodes=adj.n_nodes, block=block, n_blocks=n, index=b,
        mesh=mesh, plan=plan, plan_t=plan_t,
    )


def maybe_shard(adj: SparseAdj, mesh: Optional[Mesh], mode: str = "auto") -> Optional[ShardedAdj]:
    """The models' ``on_mesh`` policy (``graph_shard``): ``off`` keeps the
    adjacency whole, ``auto`` shards only a graph without a dense copy (a
    small graph's one matmul beats a distributed scatter), anything else
    (``on``) shards. Nothing is sharded without a mesh or with one 'data'
    rank."""
    if mesh is None or mode == "off":
        return None
    if axis_size(mesh, "data") <= 1:
        return None
    if mode == "auto" and adj.dense is not None:
        return None
    return shard_adjacency(adj, mesh)


class GatherBlocks(torch.autograd.Function):
    """The ranks' (block, d) row blocks -> the replicated (n_nodes, d):
    an all-gather over 'data'. Its backward is the reduce-scatter: the
    upstream gradient summed over 'data', this rank's block kept."""

    @staticmethod
    def forward(ctx, part, mesh, n_nodes):
        ctx.mesh, ctx.block = mesh, part.shape[0]
        return all_gather_rows(part, mesh, "data")[:n_nodes]

    @staticmethod
    def backward(ctx, grad_out):
        return reduce_scatter_rows(grad_out, ctx.mesh, "data", ctx.block), None, None


def spmm_sharded(adj: ShardedAdj, x: torch.Tensor) -> torch.Tensor:
    """Row-block-parallel A @ x (``neurec_tpu/ops/graph.py:340-449``) on a
    replicated x (n_nodes, d): each rank computes its block's rows, K2 over
    the block's plan (in ``NEUREC_SPMM_DTYPE``'s dtype, as ``spmm``), and
    the blocks are all-gathered over 'data' into the replicated (n_nodes, d)
    f32. K3 is not on this path, as in the JAX package's.

    The gradient splits between this op and the trainer. Each rank's loss
    is its part of the whole, so the upstream gradient G_r differs by rank.
    The backward sums it over 'data' and keeps the rank's block (the
    reduce-scatter of ``GatherBlocks``), then runs K2 over the block's
    transposed plan (``PlanSpmm``): dx_r = A_r^T (sum_s G_s)_r, a partial
    gradient. The trainer's all-reduce of the gradients over 'data' then
    sums the partials: sum_r A_r^T (sum_s G_s)_r = A^T (sum_s G_s), the
    whole batch's gradient, as the JAX ``f_bwd`` gives with its ``psum``.

    A block without plans (new values: NGCF's node dropout), or any block
    under ``NEUREC_SPMM_PALLAS=0``, takes the plain segment-sum over its
    edges.
    """
    if adj.plan is not None and plan_kernels_enabled():
        part = PlanSpmm.apply(x, adj.plan, adj.plan_t, spmm_ops.spmm_compute_dtype())
    else:
        gathered = x[adj.cols.long()] * adj.vals[:, None]
        part = torch.zeros((adj.block, x.shape[1]), dtype=torch.float32, device=x.device)
        part = part.index_add(0, adj.rows_local.long(), gathered)
    return GatherBlocks.apply(part, adj.mesh, adj.n_nodes)
