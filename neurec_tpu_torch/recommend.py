"""Batch top-K recommendation export — the serving job.

Port of ``neurec_tpu/recommend.py``: ``batch_topk`` ranks the full
catalogue for a set of users, batch by batch through the model's
``predict`` (for LightGCN that propagates the graph, kernel K2, every
batch), masks each user's already-consumed items to -inf and takes the
top K with the lowest item id first among ties.

Consumed items travel as per-batch (item, local-slot) edge pairs, so
memory is bounded by the interactions of one batch, never by
num_users * max_row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.ops.topk import top_k


def _batch_edges_from_csr(csr, users_pad, n_valid, n_batches, B):
    """(edge_items, edge_users) (n_batches, E_max): batch j's consumed
    items as (item, local-slot) pairs, padded with slot == B."""
    slots = users_pad.astype(np.int64)
    lens = (csr.indptr[slots + 1] - csr.indptr[slots]).astype(np.int64)
    lens[n_valid:] = 0  # pad slots contribute nothing
    total = int(lens.sum())
    if total == 0:
        return (np.zeros((n_batches, 8), np.int32), np.full((n_batches, 8), B, np.int32))
    owner = np.repeat(np.arange(len(slots), dtype=np.int64), lens)
    # each edge's index within its owner's row
    row_off = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
    )
    src = csr.indptr[slots[owner]] + row_off  # position in csr.indices
    batch_of = owner // B
    lslot_of = (owner % B).astype(np.int32)
    # edge's offset within its batch = running count restarted per batch
    batch_starts = np.searchsorted(batch_of, np.arange(n_batches))
    within = np.arange(total, dtype=np.int64) - np.repeat(
        batch_starts, np.diff(np.concatenate([batch_starts, [total]]))
    )
    e_max = int(within.max()) + 1
    e_max += (-e_max) % 8
    e_items = np.zeros((n_batches, e_max), np.int32)
    e_users = np.full((n_batches, e_max), B, np.int32)
    e_items[batch_of, within] = csr.indices[src]
    e_users[batch_of, within] = lslot_of
    return e_items, e_users


@torch.no_grad()
def batch_topk(
    model,
    params,
    k: int,
    users: Optional[np.ndarray] = None,
    train_matrix=None,
    batch_size: int = 512,
    device: DeviceLike = None,
):
    """Top-K items per user.

    Args:
      model: a registered recommender (uses its ``predict``), on ``device``.
      params: parameter dict on ``device``.
      k: list length, clamped to the catalogue size.
      users: int array of user ids; default = all users.
      train_matrix: optional CSR of already-consumed items to exclude.
      batch_size: users per batch.
      device: ``None`` = cuda (raises without one); tests pass "cpu".

    Returns:
      (item_ids, scores): int32/float32 numpy arrays of shape (len(users), k).
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError("model lives on %s, batch_topk asked for %s" % (model.device, dev))
    num_items = model.num_items
    k = min(int(k), num_items)
    if users is None:
        users = np.arange(model.num_users, dtype=np.int32)
    users = np.asarray(users, dtype=np.int32)
    n = len(users)
    B = min(batch_size, max(n, 1))
    n_batches = -(-n // B)
    users_pad = np.zeros(n_batches * B, np.int32)
    users_pad[:n] = users
    users_b = torch.from_numpy(users_pad.reshape(n_batches, B)).long().to(dev)

    masked = train_matrix is not None
    if masked:
        e_items, e_users = _batch_edges_from_csr(
            train_matrix.tocsr(), users_pad, n, n_batches, B
        )
        e_items_b = torch.from_numpy(e_items).long().to(dev)
        e_users_b = torch.from_numpy(e_users).long().to(dev)

    # dense-hoist hook: only for full-catalogue exports — a subset query
    # must not pay the all-users score matrix
    dense_hook = getattr(model, "eval_dense_scores", None)
    dense_scores = (
        dense_hook(params).float() if callable(dense_hook) and n == model.num_users else None
    )

    out_scores, out_items = [], []
    for j in range(n_batches):
        bu = users_b[j]
        scores = (
            dense_scores[bu] if dense_scores is not None
            else model.predict(params, bu).float()
        )
        if masked:
            keep = e_users_b[j] < B  # pad slots (== B) drop
            scores[e_users_b[j][keep], e_items_b[j][keep]] = float("-inf")
        s, idx = top_k(scores, k)
        out_scores.append(s)
        out_items.append(idx)
    items = torch.cat(out_items).cpu().numpy()[:n]
    scores = torch.cat(out_scores).cpu().numpy()[:n]
    return items.astype(np.int32), scores.astype(np.float32)
