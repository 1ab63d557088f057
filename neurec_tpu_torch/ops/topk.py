"""Top-K with the JAX package's order.

``jax.lax.top_k`` orders by the IEEE total order of the float values
(-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN) and returns, among
equal values, the lowest index first — an invariant the JAX evaluator and
serving job rely on. ``torch.topk`` promises no order among ties, so the
port fixes the ties at the K-th value on the device, without sorting the
row and without reading anything back to the host:

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

from typing import Tuple

import torch


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of ``x`` as
    float32: flip the magnitude bits of the negative values."""
    bits = x.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of ``x``,
    descending in the total order, ties broken to the lowest index."""
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
