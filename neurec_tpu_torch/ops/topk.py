"""Top-K with the JAX package's order.

``jax.lax.top_k`` orders by the IEEE total order of the float values
(-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN) and returns, among
equal values, the lowest index first — an invariant the JAX evaluator and
serving job rely on.

On a CUDA tensor ``top_k`` launches the hand-written kernel
(``csrc/topk.cu``: a radix select in shared memory on a composite of the
order key and the id, one read of the scores) or raises; it takes a float32
(B, I) block whose rows are contiguous (the rows may lie apart, as a slice
of a wider block does). On a CPU tensor it runs the plain version,
``top_k_reference``. ``torch.topk`` promises no order among ties, so the
plain version fixes the ties at the K-th value without sorting the row:

1. each value becomes an int32 key in the total order;
2. ``torch.topk`` of the keys gives t, the K-th key of each row: the
   ``n_gt`` entries above t are among its K, in some order;
3. the ``K - n_gt`` lowest ids whose key equals t: along the row, the
   running count of the ties; the j-th tie is the first id where the count
   reaches j (``torch.searchsorted``), so no second full-row top-K is
   needed;
4. the two sets merge, ordered by (key desc, id asc) with two sorts of K.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from neurec_tpu_torch.ops import _build

# the kernel's paths, as it reports the one it took (csrc/topk.cu chooses by
# the row's length): the row resident in a block's shared memory, or streamed
# from device memory
PATHS = ("resident", "streamed")

_TOPK = _build.Entry("topk", "neurec_topk", [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of ``x`` as
    float32: flip the magnitude bits of the negative values."""
    bits = x.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k_reference(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version (module docstring): any float dtype, any leading
    axes."""
    key = order_key(x)
    top, idx = torch.topk(key, k, dim=-1, sorted=False)
    t = top.amin(-1, keepdim=True)
    above = top > t
    n_gt = above.sum(-1, keepdim=True)
    count = torch.cumsum(key == t, dim=-1, dtype=torch.int32)
    j = torch.arange(k, device=x.device)
    tie = torch.searchsorted(count, (j + 1 - n_gt).clamp_min(1).int().contiguous())
    # the n_gt entries above t first (in any order), then the lowest ties
    first = torch.sort((~above).to(torch.uint8), dim=-1, stable=True)[1]
    ids = torch.where(j < n_gt, idx.gather(-1, first), tie)
    ids = torch.sort(ids, dim=-1)[0]
    order = torch.sort(key.gather(-1, ids), dim=-1, descending=True, stable=True)[1]
    ids = ids.gather(-1, order)
    return x.gather(-1, ids), ids


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of ``x``,
    descending in the total order, ties broken to the lowest index."""
    if x.device.type == "cpu":
        return top_k_reference(x, k)
    return top_k_kernel(x, k)


@_build.swappable
def top_k_kernel(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k`` by the kernel: ``x`` a float32 (B, I) block with unit
    stride along a row, 1 <= k <= I. ``LAUNCHES`` counts ``topk`` and
    ``topk_<path>``, the path the kernel took."""
    if x.dtype != torch.float32:
        raise TypeError("the top-K kernel takes float32 scores, got %s" % x.dtype)
    if x.dim() != 2:
        raise ValueError("the top-K kernel takes a (B, I) block, got shape %s" % (tuple(x.shape),))
    B, I = x.shape
    if I and (x.stride(1) != 1 or (B > 1 and x.stride(0) < I)):
        raise ValueError("the top-K kernel takes rows of unit stride, got strides %s" % (x.stride(),))
    if not 1 <= k <= I:
        raise ValueError("k must lie in 1..%d, got %d" % (I, k))
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    ids = torch.empty((B, k), dtype=torch.int64, device=x.device)
    if B:
        path = _run(x, k, vals, ids)
        _build.LAUNCHES["topk"] += 1
        _build.LAUNCHES["topk_" + path] += 1
    return vals, ids


def _run(x: torch.Tensor, k: int, vals: torch.Tensor, ids: torch.Tensor, streamed: bool = False) -> str:
    """Launch the kernel on the current stream; returns the path it took
    (one of ``PATHS``). ``streamed`` takes the streamed path whatever the
    row's length: the tests hold both paths to one answer."""
    if x.device.type != "cuda":
        raise ValueError("the top-K kernel runs on cuda, not %s" % x.device)
    B, I = x.shape
    ld = x.stride(0) if B > 1 else I
    path = ctypes.c_int(-1)
    _TOPK(x.device, x.data_ptr(), ld, B, I, k, vals.data_ptr(), ids.data_ptr(), int(streamed), ctypes.byref(path))
    return PATHS[path.value]
