"""K2: the plan SpMM, A @ x over a chunked-COO scatter plan.

Port of ``neurec_tpu/ops/pallas_spmm.py``: the same host-built plan
(``build_spmm_plan`` gives arrays identical to the JAX one) and the same
function, ``out[chunk_tile[i]*tile_r + rows[i,e]] += vals[i,e] * x[cols[i,e]]``.
On a CUDA tensor ``plan_spmm`` launches the hand-written kernel in
``csrc/plan_spmm.cu``, which fuses the gather of x that the TPU design
leaves to XLA; on a CPU tensor it runs ``plan_spmm_reference``.

The plan also carries ``tile_ptr`` (n_tiles + 1), built once on the host
from ``chunk_tile``, so that a CUDA block can find its tile's chunks.

The backward of A @ x is the same kernel over the transposed plan
(``build_spmm_plan(cols, rows, vals, n)``, marked ``transposed``), as in the
JAX package's ``make_spmm``; ``ops/graph.py::PlanSpmm`` wires it into
autograd. A launch over a transposed plan counts as ``plan_spmm_t``.

Not ported yet: the bf16 feature path and the lane-packed variant (K3).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import numpy as np
import torch

from neurec_tpu_torch.ops import _build

ArrayLike = Union[np.ndarray, torch.Tensor]


class SpmmPlan(NamedTuple):
    """Chunked-COO scatter plan (host-built once).

    Every tile owns >= 1 chunk (all padding if empty), so every output
    tile is zeroed. ``build_spmm_plan`` returns numpy arrays;
    :meth:`to` gives the same plan as tensors on a device.
    """

    rows: ArrayLike        # (n_chunks, chunk) int32 — dest row MINUS tile start
    cols: ArrayLike        # (n_chunks, chunk) int32 — global source node id
    vals: ArrayLike        # (n_chunks, chunk) float32 — 0.0 on padding
    chunk_tile: ArrayLike  # (n_chunks,) int32 — non-decreasing out-tile index
    chunk_first: ArrayLike  # (n_chunks,) int32 — 1 iff first chunk of its tile
    tile_ptr: ArrayLike    # (n_tiles + 1,) int32 — tile t owns chunks [ptr[t], ptr[t+1])
    n_rows: int            # logical output rows (<= n_tiles * tile_r)
    tile_r: int
    transposed: bool = False  # the plan of A^T (a backward), counted apart

    @property
    def n_tiles(self) -> int:
        return -(-self.n_rows // self.tile_r)

    def to(self, device) -> "SpmmPlan":
        return self._replace(**{
            name: torch.as_tensor(getattr(self, name), device=device)
            for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first", "tile_ptr")
        })


def build_spmm_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    tile_r: int = 256,
    chunk: int = 256,
) -> SpmmPlan:
    """Partition COO edges into per-row-tile chunk lists (numpy, host).

    Edges are sorted by (dest tile, source col): tile-grouped for the
    scatter, column-ascending within a tile for gather locality.
    """
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    tile = rows // tile_r
    order = np.lexsort((cols, tile))
    rows, cols, vals, tile = rows[order], cols[order], vals[order], tile[order]

    n_tiles = -(-n_rows // tile_r)
    counts = np.bincount(tile, minlength=n_tiles)
    chunks_per_tile = np.maximum(-(-counts // chunk), 1)
    n_chunks = int(chunks_per_tile.sum())

    r = np.zeros((n_chunks, chunk), dtype=np.int32)
    c = np.zeros((n_chunks, chunk), dtype=np.int32)
    v = np.zeros((n_chunks, chunk), dtype=np.float32)
    chunk_tile = np.zeros(n_chunks, dtype=np.int32)
    chunk_first = np.zeros(n_chunks, dtype=np.int32)

    starts = np.concatenate([[0], np.cumsum(counts)])
    ci = 0
    for t in range(n_tiles):
        lo, hi = int(starts[t]), int(starts[t + 1])
        chunk_first[ci] = 1
        for s in range(lo, hi, chunk) or [lo]:  # >=1 chunk even when empty
            k = min(chunk, hi - s)
            if k > 0:
                r[ci, :k] = rows[s : s + k] - t * tile_r
                c[ci, :k] = cols[s : s + k]
                v[ci, :k] = vals[s : s + k]
            chunk_tile[ci] = t
            ci += 1
    if ci != n_chunks:
        raise AssertionError("plan chunk count mismatch")

    tile_ptr = np.searchsorted(chunk_tile, np.arange(n_tiles + 1)).astype(np.int32)
    return SpmmPlan(
        rows=r,
        cols=c,
        vals=v,
        chunk_tile=chunk_tile,
        chunk_first=chunk_first,
        tile_ptr=tile_ptr,
        n_rows=n_rows,
        tile_r=tile_r,
    )


def plan_spmm_reference(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, scale, segment-sum."""
    dest = (plan.chunk_tile.long()[:, None] * plan.tile_r + plan.rows.long()).reshape(-1)
    contrib = x[plan.cols.reshape(-1).long()] * plan.vals.reshape(-1, 1)
    out = torch.zeros((plan.n_tiles * plan.tile_r, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, dest, contrib)
    return out[: plan.n_rows]


def plan_spmm(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """(n_rows, d) f32 = A @ x for the plan's sparse A (x f32, plan on x's device)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError("plan_spmm takes a 2-D float32 x, got %s %s" % (x.dtype, tuple(x.shape)))
    for name in ("rows", "cols", "vals", "tile_ptr"):
        if getattr(plan, name).device != x.device:
            raise ValueError("plan.%s is on %s, x on %s" % (name, getattr(plan, name).device, x.device))
    if x.device.type == "cpu":
        return plan_spmm_reference(plan, x)
    if x.device.type != "cuda":
        raise ValueError("plan_spmm runs on cuda or cpu, not %s" % x.device)
    if plan.tile_r > 512:
        raise ValueError("the kernel's tile accumulator holds at most 512 rows")
    x = x.contiguous()
    n_chunks, chunk = plan.rows.shape
    arrays = (plan.rows, plan.cols, plan.vals, plan.tile_ptr)
    dtypes = (torch.int32, torch.int32, torch.float32, torch.int32)
    if (
        any(a.dtype != t or not a.is_contiguous() for a, t in zip(arrays, dtypes))
        or plan.cols.shape != (n_chunks, chunk)
        or plan.vals.shape != (n_chunks, chunk)
        or plan.tile_ptr.shape != (plan.n_tiles + 1,)
    ):
        raise ValueError("malformed plan for the plan_spmm kernel")
    out = torch.empty((plan.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    lib = _build.load("plan_spmm", x.device)
    fn = lib.neurec_plan_spmm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        code = fn(
            plan.rows.data_ptr(), plan.cols.data_ptr(), plan.vals.data_ptr(),
            plan.tile_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
            plan.n_tiles, chunk, plan.tile_r, plan.n_rows, x.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "plan_spmm")
    _build.LAUNCHES["plan_spmm_t" if plan.transposed else "plan_spmm"] += 1
    return out
