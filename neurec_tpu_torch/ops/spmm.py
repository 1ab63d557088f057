"""K2 and K3: the plan SpMM, A @ x over a chunked-COO scatter plan.

Port of ``neurec_tpu/ops/pallas_spmm.py``: the same host-built plan
(``build_spmm_plan`` gives arrays identical to the JAX one, its geometry
from ``NEUREC_SPMM_TILE`` / ``NEUREC_SPMM_CHUNK`` as there) and the same
function, ``out[chunk_tile[i]*tile_r + rows[i,e]] += vals[i,e] * x[cols[i,e]]``.

``plan_spmm`` routes as the JAX one does: ``pack_factor`` picks the
lane-packed kernel (K3, ``plan_spmm_packed``) or the plain one (K2,
``plan_scatter``). On a CUDA tensor each launches its hand-written kernel
(``csrc/plan_spmm.cu``, ``csrc/plan_spmm_packed.cu``), which fuse the
gather of x that the TPU design leaves to XLA; on a CPU tensor each runs
its plain version (``plan_spmm_reference``, ``plan_spmm_packed_reference``).

With bf16 features the TPU kernel rounds the selector to bf16 as well
(``sel.astype(g.dtype)``): ``vals`` are rounded to bf16, the products and
sums are f32, and the output is f32 — in the kernels and the plain
versions alike.

The plan also carries a cache of what the kernels derive from it on its
device: the parity-grouped layouts of K3 (``packed_layout``, once per pack
factor) and the edge-balanced schedule that both kernels walk
(``spmm_schedule``, once per plan). The schedule lists the real edges by
(row, plan order) and cuts them into spans of at most ``SPAN`` edges and
rows, one per warp, so that no warp waits on a hub; it does not depend on
the plan's chunk or padding, so every plan of one graph sums each row in
the same order.

The backward of A @ x is the same function over the transposed plan
(``build_spmm_plan(cols, rows, vals, n)``, marked ``transposed``), as in the
JAX package's ``make_spmm``; ``ops/graph.py::PlanSpmm`` wires it into
autograd. Launches over a transposed plan count as ``plan_spmm_t`` (K2) and
``plan_spmm_packed_t`` (K3).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

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
    n_rows: int            # logical output rows (<= n_tiles * tile_r)
    tile_r: int
    transposed: bool = False  # the plan of A^T (a backward), counted apart
    # derived on the plan's device: pack -> (rows_p, vals_p) (packed_layout),
    # "schedule" -> SpmmSchedule (spmm_schedule), "checked_on" -> the device
    # a launch last validated the plan for (_check_launch)
    cache: Optional[dict] = None

    @property
    def n_tiles(self) -> int:
        return -(-self.n_rows // self.tile_r)

    def to(self, device) -> "SpmmPlan":
        return self._replace(cache={}, **{
            name: torch.as_tensor(getattr(self, name), device=device)
            for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first")
        })


# Edges, and rows, one warp of K2/K3 takes (csrc/plan_spmm_core.cuh SPAN):
# one edge a lane when the warp reads its span's (col, val), and 32 x rows
# of 256 B in flight per warp. Rows of more edges are cut into pieces.
SPAN = 32


def default_tile_chunk() -> Tuple[int, int]:
    """(tile_r, chunk) from ``NEUREC_SPMM_TILE`` / ``NEUREC_SPMM_CHUNK``,
    256 / 256 when unset, read as the JAX package's ``_default_tile_chunk``."""
    return (
        int(os.environ.get("NEUREC_SPMM_TILE", 256)),
        int(os.environ.get("NEUREC_SPMM_CHUNK", 256)),
    )


def pack_factor(d: int, chunk: int) -> int:
    """Edges per packed gather, from ``NEUREC_SPMM_PACK`` (the JAX
    package's ``_pack_factor``): "", ``auto``, 0 and 1 give 1; otherwise
    the factor halves until ``chunk % p == 0`` and ``(d * p) % 128 == 0``."""
    flag = os.environ.get("NEUREC_SPMM_PACK", "auto")
    if flag in ("", "auto", "0", "1"):
        return 1
    p = int(flag)
    while p > 1 and (chunk % p != 0 or (d * p) % 128 != 0):
        p //= 2
    return max(p, 1)


def spmm_compute_dtype() -> Optional[torch.dtype]:
    """Feature dtype of the SpMM gather and products, from
    ``NEUREC_SPMM_DTYPE``: ``f32``/``float32`` -> None (f32), ``bf16``/
    ``bfloat16`` -> ``torch.bfloat16``; anything else but ``auto`` raises.

    ``auto`` is f32 on every device of the port. The JAX package's ``auto``
    is bf16 on a TPU because the MXU's default precision already rounds f32
    operands to bf16, so an explicit cast costs no accuracy there; it is f32
    on the CPU and in interpret mode. The port runs with TF32 off, so on the
    card f32 is exact, and ``auto`` keeps the port's numbers on the card and
    on the CPU equal to the JAX package's on the CPU.
    """
    flag = os.environ.get("NEUREC_SPMM_DTYPE", "auto")
    if flag in ("bf16", "bfloat16"):
        return torch.bfloat16
    if flag in ("f32", "float32", "auto"):
        return None
    raise ValueError("NEUREC_SPMM_DTYPE must be 'f32', 'bf16' or 'auto', got %r" % flag)


def build_spmm_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    tile_r: Optional[int] = None,
    chunk: Optional[int] = None,
) -> SpmmPlan:
    """Partition COO edges into per-row-tile chunk lists (numpy, host).

    ``tile_r`` / ``chunk`` default to ``default_tile_chunk()``. Edges are
    sorted by (dest tile, source col): tile-grouped for the scatter,
    column-ascending within a tile for gather locality.
    """
    d_tile, d_chunk = default_tile_chunk()
    tile_r = d_tile if tile_r is None else tile_r
    chunk = d_chunk if chunk is None else chunk
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

    return SpmmPlan(
        rows=r,
        cols=c,
        vals=v,
        chunk_tile=chunk_tile,
        chunk_first=chunk_first,
        n_rows=n_rows,
        tile_r=tile_r,
    )


def _selector(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The edge values as the products see them: rounded to bf16 when x is."""
    return vals.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else vals


def plan_spmm_reference(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: gather, scale, segment-sum (f32 out)."""
    dest = (plan.chunk_tile.long()[:, None] * plan.tile_r + plan.rows.long()).reshape(-1)
    contrib = x[plan.cols.reshape(-1).long()].float() * _selector(plan.vals, x).reshape(-1, 1)
    out = torch.zeros((plan.n_tiles * plan.tile_r, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, dest, contrib)
    return out[: plan.n_rows]


def packed_layout(plan: SpmmPlan, pack: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows_p, vals_p)``, each ``(n_chunks * pack, chunk // pack)``: row
    ``i * pack + h`` holds parity group h (edges h, h + pack, ...) of chunk
    i, as ``plan_spmm_packed`` builds them (``pallas_spmm.py:314-319``).
    Built on the plan's device once per pack and kept with the plan."""
    cache = plan.cache
    if cache is not None and pack in cache:
        return cache[pack]
    n_chunks, chunk = plan.rows.shape
    if chunk % pack:
        raise ValueError("chunk %d is not a multiple of pack %d" % (chunk, pack))

    def group(a):
        a = torch.as_tensor(a)
        return a.reshape(n_chunks, chunk // pack, pack).transpose(1, 2).reshape(n_chunks * pack, chunk // pack).contiguous()

    out = (group(plan.rows), group(plan.vals))
    if cache is not None:
        cache[pack] = out
    return out



class SpmmSchedule(NamedTuple):
    """A plan's edge-balanced schedule (``spmm_schedule``), on its device.

    Row r's real edges are ``perm[row_ptr[r]:row_ptr[r+1]]``, in plan
    order, and ``cols`` holds their source columns in the same order, so
    that a warp reads its span's columns coalesced. Span s, one warp's
    work, sums the edges ``perm[e0:e1]`` into the rows ``r0 .. r1-1``
    (``spans[s] = (e0, e1, r0, r1)``): whole rows, each
    row without edges counting as one edge, at most ``SPAN`` edges and
    ``SPAN`` rows. A row of more than ``SPAN`` edges is cut into pieces of
    ``SPAN`` edges, each at the start of its own span (the last piece's span
    may go on with the next rows); ``split`` lists those rows as ``(row, s0,
    s1)``, pieces in spans ``s0 .. s1-1``, which the kernels add in span
    order.
    """

    perm: torch.Tensor     # (n_edges,) int32 — plan positions, flat over (n_chunks, chunk)
    cols: torch.Tensor     # (n_edges,) int32 — plan.cols at perm
    row_ptr: torch.Tensor  # (n_rows + 1,) int32
    spans: torch.Tensor    # (n_spans, 4) int32 — (e0, e1, r0, r1)
    split: torch.Tensor    # (n_split, 3) int32 — (row, s0, s1)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _cut_spans(deg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy cut of rows with ``deg`` edges each into spans (see
    ``SpmmSchedule``): ``(spans (n_spans, 4), split (n_split, 3))``."""
    spans, split = [], []
    cur, fill, e = None, 0, 0  # the open span [e0, e1, r0, r1], its cost, row r's first edge
    for r, n in enumerate(deg.tolist()):
        if n > SPAN:  # full pieces in spans of their own; the last piece opens a span
            if cur is not None:
                spans.append(cur)
            pieces = -(-n // SPAN)
            split.append([r, len(spans), len(spans) + pieces])
            spans.extend([e + k * SPAN, e + (k + 1) * SPAN, r, r + 1] for k in range(pieces - 1))
            cur = [e + (pieces - 1) * SPAN, e + n, r, r + 1]
            fill = cur[1] - cur[0]
        else:
            if cur is None or fill + max(n, 1) > SPAN:
                if cur is not None:
                    spans.append(cur)
                cur, fill = [e, e, r, r], 0
            cur[1], cur[3] = e + n, r + 1
            fill += max(n, 1)
        e += n
    if cur is not None:
        spans.append(cur)
    return (np.asarray(spans, dtype=np.int32).reshape(-1, 4),
            np.asarray(split, dtype=np.int32).reshape(-1, 3))


def spmm_schedule(plan: SpmmPlan) -> SpmmSchedule:
    """The plan's edge-balanced schedule, which K2 and K3 walk: its real
    (non-zero) edges by (row, plan order), cut into spans. Built on the
    plan's device once per plan and kept with it; the degrees go through
    the host for the cut.

    It does not depend on the plan's chunk or padding: two plans of one
    graph differ only in ``perm`` (their positions): ``vals[perm]``,
    ``cols``, ``row_ptr``, ``spans`` and ``split`` are equal.
    """
    cache = plan.cache
    if cache is not None and "schedule" in cache:
        return cache["schedule"]
    vals = torch.as_tensor(plan.vals)
    dev, chunk = vals.device, vals.shape[1]
    pos = torch.nonzero(vals.reshape(-1) != 0).squeeze(1)
    first_row = torch.as_tensor(plan.chunk_tile, device=dev).long() * plan.tile_r
    rows = first_row[pos // chunk] + torch.as_tensor(plan.rows, device=dev).reshape(-1)[pos].long()
    rows, order = torch.sort(rows, stable=True)  # plan order within a row
    deg = torch.bincount(rows, minlength=plan.n_rows)
    row_ptr = torch.zeros(plan.n_rows + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(deg, 0)
    spans, split = _cut_spans(deg.cpu().numpy())
    perm = pos[order]
    sched = SpmmSchedule(
        perm=perm.int(), cols=torch.as_tensor(plan.cols, device=dev).reshape(-1)[perm].contiguous(),
        row_ptr=row_ptr.int(),
        spans=torch.from_numpy(spans).to(dev), split=torch.from_numpy(split).to(dev),
    )
    if cache is not None:
        cache["schedule"] = sched
    return sched


def plan_spmm_packed_reference(plan: SpmmPlan, x: torch.Tensor, pack: int) -> torch.Tensor:
    """Plain PyTorch version of K3, over the parity-grouped plan and the
    packed gather ``x[cols.reshape(-1, pack)]``: for chunk i, group h and
    packed row j, ``out[chunk_tile[i]*tile_r + rows_p[i*pack+h, j]] +=
    vals_p[i*pack+h, j] * x[cols[i, j*pack+h]]``."""
    rows_p, vals_p = packed_layout(plan, pack)
    n_chunks, chunk = plan.cols.shape
    cpp, d = chunk // pack, x.shape[1]
    g = x[plan.cols.reshape(-1, pack).long()].float().reshape(n_chunks, cpp, pack, d)
    rows_hj = rows_p.reshape(n_chunks, pack, cpp).transpose(1, 2).long()  # (n_chunks, cpp, pack)
    vals_hj = _selector(vals_p, x).reshape(n_chunks, pack, cpp).transpose(1, 2)
    dest = plan.chunk_tile.long()[:, None, None] * plan.tile_r + rows_hj
    out = torch.zeros((plan.n_tiles * plan.tile_r, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, dest.reshape(-1), (g * vals_hj[..., None]).reshape(-1, d))
    return out[: plan.n_rows]


def _check_launch(plan: SpmmPlan, x: torch.Tensor, what: str) -> bool:
    """True for a CUDA launch, False for the CPU's plain version; raises on
    what the kernels do not take. The plan's own checks run once per device
    the plan is used on (the verdict is kept in its cache): they are most
    of the host time of a launch."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError("%s takes a 2-D float32 or bfloat16 x, got %s %s" % (what, x.dtype, tuple(x.shape)))
    dev = x.device
    if plan.cache is None or plan.cache.get("checked_on") != dev:
        for name in ("rows", "cols", "vals", "chunk_tile"):
            if getattr(plan, name).device != dev:
                raise ValueError("plan.%s is on %s, x on %s" % (name, getattr(plan, name).device, dev))
        n_chunks, chunk = plan.rows.shape
        arrays = (plan.rows, plan.cols, plan.vals, plan.chunk_tile)
        dtypes = (torch.int32, torch.int32, torch.float32, torch.int32)
        if dev.type == "cuda" and (
            any(a.dtype != t or not a.is_contiguous() for a, t in zip(arrays, dtypes))
            or plan.cols.shape != (n_chunks, chunk)
            or plan.vals.shape != (n_chunks, chunk)
            or plan.chunk_tile.shape != (n_chunks,)
            or plan.rows.numel() >= 2 ** 31  # positions are int32
        ):
            raise ValueError("malformed plan for the %s kernel" % what)
        if plan.cache is not None:
            plan.cache["checked_on"] = dev
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError("%s runs on cuda or cpu, not %s" % (what, dev))
    if x.dtype == torch.bfloat16 and x.shape[1] % 2:
        raise ValueError("%s copies x in units of 4 bytes: a bfloat16 x needs an even d, got %d"
                         % (what, x.shape[1]))
    return True


# kernel name -> (library, entry point with its argument types set)
_ENTRIES: Dict[str, Tuple[ctypes.CDLL, Any]] = {}


def _launch(name: str, plan: SpmmPlan, x: torch.Tensor, vals: torch.Tensor, *ints: int) -> torch.Tensor:
    """Run kernel ``name`` (K2 ``plan_spmm`` or K3 ``plan_spmm_packed``)
    along the plan's schedule; ``ints`` are the entry point's own integer
    arguments before ``x_bf16``."""
    sched = spmm_schedule(plan)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    d = x.shape[1]
    out = torch.empty((plan.n_rows, d), dtype=torch.float32, device=x.device)
    n_spans, n_split = sched.spans.shape[0], sched.split.shape[0]
    # one scratch row per span; the spans that hold a piece of a cut row write theirs
    partial = torch.empty((n_spans, d), dtype=torch.float32, device=x.device) if n_split else None
    if name not in _ENTRIES:
        lib = _build.load(name, x.device)
        fn = getattr(lib, "neurec_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (2 + len(ints) + 1) + [ctypes.c_void_p]
        _ENTRIES[name] = (lib, fn)
    lib, fn = _ENTRIES[name]
    switch = x.device.index != torch.cuda.current_device()
    with torch.cuda.device(x.device) if switch else contextlib.nullcontext():
        code = fn(
            sched.perm.data_ptr(), sched.cols.data_ptr(), sched.row_ptr.data_ptr(), sched.spans.data_ptr(),
            sched.split.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            n_spans, n_split, *ints, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, name)
    return out


def plan_scatter(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """K2: (n_rows, d) f32 = A @ x for the plan's sparse A (x f32 or bf16,
    plan on x's device). A launch is the span kernel, plus a fix-up kernel
    where the schedule cut rows."""
    if not _check_launch(plan, x, "plan_spmm"):
        return plan_spmm_reference(plan, x)
    out = _launch("plan_spmm", plan, x, plan.vals, x.shape[1])
    _build.LAUNCHES["plan_spmm_t" if plan.transposed else "plan_spmm"] += 1
    return out


def plan_spmm_packed(plan: SpmmPlan, x: torch.Tensor, pack: int) -> torch.Tensor:
    """K3: A @ x with ``pack`` (2 or 4) edges' rows fetched per load
    instruction, reading the edge values from the parity-grouped plan
    (``packed_layout``); f32 out, x f32 or bf16, K2's bits."""
    if pack not in (2, 4):
        raise ValueError("pack must be 2 or 4, got %d" % pack)
    _, vals_p = packed_layout(plan, pack)
    if not _check_launch(plan, x, "plan_spmm_packed"):
        return plan_spmm_packed_reference(plan, x, pack)
    out = _launch("plan_spmm_packed", plan, x, vals_p, plan.rows.shape[1], x.shape[1], pack)
    _build.LAUNCHES["plan_spmm_packed_t" if plan.transposed else "plan_spmm_packed"] += 1
    return out


def plan_spmm(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """(n_rows, d) f32 = A @ x in x's dtype (f32 or bf16; ``PlanSpmm``
    casts to ``spmm_compute_dtype()`` first), routed as the JAX package's
    ``plan_spmm``: K3 when ``pack_factor`` gives more than 1, else K2. The
    module-level wrappers are looked up at each call, so replacing one
    (with its plain version) reaches here."""
    pack = pack_factor(x.shape[1], plan.rows.shape[1])
    if pack > 1:
        return plan_spmm_packed(plan, x, pack)
    return plan_scatter(plan, x)
