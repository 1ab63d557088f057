"""Exact top-K indices from a few hot segments (port of
``neurec_tpu/ops/fast_topk.py``).

The same result as ``ops/topk.py::top_k`` (the same ids, the lowest id
first among ties) from less than a full-row top-K:

1. a lower bound ``t0`` of each row's K-th value t: the K-th largest of any
   K distinct entries of the row can only be <= t. Here those entries are
   the per-segment maxima (length-``seg`` segments) when there are at least
   K segments, else the row itself (exact). The JAX package takes
   ``approx_max_k``'s values, which torch has no counterpart of (on the CPU
   it is exact, so there its ``t0`` is t itself and this one is no higher:
   this hot set holds the JAX one, and its overflow is no lower);
2. the segments holding any value >= t0 are hot. Every true top-K element
   is >= t >= t0, so it lies in a hot segment. The first ``max_hot`` hot
   segment ids, ascending, are picked (cold segments fill the rest);
3. the picked segments are gathered, (B, max_hot * seg), and re-ranked with
   ``top_k``; the local winners map back to global ids.

Exactness: a row with more than ``max_hot`` hot segments may lose a
candidate; such rows are counted in ``overflow`` (and any id >= I, never
reached with k <= I, is folded in), and a caller falls back to ``top_k``
there. Ties: the hot segments are gathered in ascending id order, so the
flat positions of the values >= t0 keep the global order, and ``top_k``
keeps the lowest flat position first; cold filler is < t0 <= t and never
ties at the K-th place.

Everything runs on the tensor's device, with no host sync. Nothing in the
port calls it: it is measured against ``top_k`` by
``benchmarks/topk_ab.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurec_tpu_torch.ops.topk import top_k


def exact_topk_indices(
    x: torch.Tensor,  # (B, I) float32 scores (may contain -inf)
    k: int,
    seg: int = 128,
    max_hot: int = 64,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indices (B, k) int32, overflow int32 scalar)``; ``indices`` equals
    ``top_k(x, k)[1]`` wherever ``overflow == 0``. ``recall_target`` is kept
    for the JAX signature and unused (it tunes ``approx_max_k``)."""
    B, I = x.shape
    if k > I:
        # pad columns (-inf) would be picked with ids >= I where top_k has
        # no column at all
        raise ValueError("exact_topk_indices needs k <= row length, got k=%d > I=%d" % (k, I))
    i_pad = (-I) % seg
    if i_pad:
        x = torch.nn.functional.pad(x, (0, i_pad), value=float("-inf"))
    n_seg = (I + i_pad) // seg
    x3 = x.reshape(B, n_seg, seg)

    if n_seg >= k:
        t0 = torch.topk(x3.amax(dim=2), k, dim=1).values[:, k - 1]  # (B,) <= t
    else:
        t0 = torch.topk(x, k, dim=1).values[:, k - 1]
    hot = (x3 >= t0[:, None, None]).any(dim=2)  # (B, n_seg)
    overflow = (hot.sum(dim=1) > max_hot).sum(dtype=torch.int32)

    # the first H hot segment ids ascending, then cold ones: distinct keys
    H = min(max_hot, n_seg)
    seg_id = torch.arange(n_seg, device=x.device)
    key = torch.where(hot, seg_id, seg_id + n_seg)
    seg_pick = torch.topk(key, H, dim=1, largest=False, sorted=True).indices  # (B, H)

    gathered = torch.gather(x3, 1, seg_pick[:, :, None].expand(B, H, seg))
    loc = top_k(gathered.reshape(B, H * seg), k)[1]  # (B, k) flat positions
    idx = torch.gather(seg_pick, 1, loc // seg) * seg + loc % seg
    overflow = overflow + (idx >= I).any(dim=1).sum(dtype=torch.int32)
    return idx.to(torch.int32), overflow
