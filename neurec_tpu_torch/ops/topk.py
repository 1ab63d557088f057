"""Top-K with the JAX package's tie order.

``jax.lax.top_k`` returns, among equal values, the lowest index first —
an invariant the JAX evaluator and serving job rely on. ``torch.topk``
does not promise any order among ties, so the port takes a stable
descending sort, which keeps equal values in index order, and slices.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of ``x``,
    descending, ties broken to the lowest index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
