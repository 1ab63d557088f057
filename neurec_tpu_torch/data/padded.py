"""Padded per-user interaction rows (port of ``neurec_tpu/data/padded.py``).

``PaddedUserItems`` holds, for every user row:

* ``items``:   (num_users, max_len) int32, ascending-sorted item ids,
               padded with ``num_items`` (one past the last valid id), so a
               pad never equals a candidate in ``[0, num_items)``;
* ``lengths``: (num_users,) int32 count of valid entries.

It is the sampler's exclusion table (``ops/sampling.py``) and the source
of the dense interaction rows of the autoencoders (``dense_rows``).
``build_padded_bytime`` orders each row by timestamp instead (the
sequential models' histories).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.sparse import csr_matrix


class PaddedUserItems(NamedTuple):
    items: np.ndarray    # (U, L) int32, sorted per row, padded with num_items
    lengths: np.ndarray  # (U,) int32
    num_items: int       # pad value == vocabulary size

    @property
    def max_len(self) -> int:
        return int(self.items.shape[1])


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_padded_positives(
    matrix: csr_matrix,
    pad_multiple: int = 8,
    min_len: int = 8,
) -> PaddedUserItems:
    """CSR -> padded sorted per-user item rows, the row length rounded up to
    ``pad_multiple`` and at least ``min_len``."""
    num_users, num_items = matrix.shape
    indptr, indices = matrix.indptr, matrix.indices
    lengths = np.diff(indptr).astype(np.int32)
    max_len = max(int(lengths.max()) if num_users else 0, min_len)
    max_len = _round_up(max_len, pad_multiple)

    items = np.full((num_users, max_len), num_items, dtype=np.int32)
    for u in range(num_users):
        lo, hi = indptr[u], indptr[u + 1]
        if hi > lo:
            items[u, : hi - lo] = np.sort(indices[lo:hi])
    return PaddedUserItems(items=items, lengths=lengths, num_items=num_items)


def build_padded_bytime(
    time_matrix: csr_matrix,
    train_matrix: csr_matrix,
    pad_multiple: int = 8,
    min_len: int = 8,
) -> PaddedUserItems:
    """Padded per-user item rows ordered by interaction timestamp (a stable
    sort: equal times keep their CSR order), padded with ``num_items``.

    The rows are in time order, not sorted by id: never use them for
    membership. ``train_matrix`` is not read; it is kept for the JAX
    package's signature.
    """
    num_users, num_items = time_matrix.shape
    indptr, indices, times = time_matrix.indptr, time_matrix.indices, time_matrix.data
    lengths = np.diff(indptr).astype(np.int32)
    max_len = max(int(lengths.max()) if num_users else 0, min_len)
    max_len = _round_up(max_len, pad_multiple)

    items = np.full((num_users, max_len), num_items, dtype=np.int32)
    for u in range(num_users):
        lo, hi = indptr[u], indptr[u + 1]
        if hi > lo:
            order = np.argsort(times[lo:hi], kind="stable")
            items[u, : hi - lo] = indices[lo:hi][order]
    return PaddedUserItems(items=items, lengths=lengths, num_items=num_items)


def dense_rows(rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(B, n_cols) float32 0/1 rows from (B, L) padded ids (pad ``n_cols``):
    one scatter into a dump column past the last id, then the dump column
    dropped. No host sync (no boolean index)."""
    out = torch.zeros((rows.shape[0], n_cols + 1), dtype=torch.float32, device=rows.device)
    out.scatter_(1, rows.long(), 1.0)
    return out[:, :n_cols]
