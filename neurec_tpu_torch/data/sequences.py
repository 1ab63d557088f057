"""Sequence padding and time-order windows (port of
``neurec_tpu/data/sequences.py``; util/tool.py:154-195 pad_sequences and
data/sampler.py:42-68). Numpy only, a copy of the JAX package's code."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def pad_sequences(
    sequences: Sequence[Sequence],
    value: float = 0.0,
    max_len: Optional[int] = None,
    padding: str = "post",
    truncating: str = "post",
    dtype=np.int32,
) -> np.ndarray:
    """Pad a list of variable-length lists into a dense 2-D array.

    ``padding`` / ``truncating`` in {"pre", "post"} say which end is padded
    or truncated, as in the reference.
    """
    if max_len is None:
        max_len = max((len(s) for s in sequences), default=0)
    out = np.full((len(sequences), max_len), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if len(seq) > max_len:
            if truncating == "pre":
                seq = seq[-max_len:]
            elif truncating == "post":
                seq = seq[:max_len]
            else:
                raise ValueError("truncating must be 'pre' or 'post'")
        if not seq:
            continue
        if padding == "post":
            out[i, : len(seq)] = seq
        elif padding == "pre":
            out[i, -len(seq):] = seq
        else:
            raise ValueError("padding must be 'pre' or 'post'")
    return out


def user_seq_windows(user_items: List[List[int]], high_order: int):
    """(user, recent_items[high_order], next_item) training instances: each
    user with more than ``high_order`` time-ordered items gives
    ``len(items) - high_order`` of them. Returns numpy int32 arrays
    ``(users (N,), recents (N, high_order), targets (N,))``."""
    users, recents, targets = [], [], []
    for user, seq in enumerate(user_items):
        n = len(seq) - high_order
        if n <= 0:
            continue
        for idx in range(n):
            users.append(user)
            recents.append(seq[idx: idx + high_order])
            targets.append(seq[idx + high_order])
    return (
        np.asarray(users, dtype=np.int32),
        np.asarray(recents, dtype=np.int32),
        np.asarray(targets, dtype=np.int32),
    )
