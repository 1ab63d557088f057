"""Batch top-K recommendation export — the serving job.

Port of ``neurec_tpu/recommend.py``: ``batch_topk`` ranks the full
catalogue for a set of users, batch by batch through the model's
``predict`` (for LightGCN that propagates the graph, kernel K2, every
batch), masks each user's already-consumed items to -inf and takes the
top K with the lowest item id first among ties.

Consumed items travel as per-batch (item, local-slot) edge pairs, so
memory is bounded by the interactions of one batch, never by
num_users * max_row. A batch's edge count is padded to a power of two (at
least 8) with pairs whose slot is B, which the mask drops, so requests of
one size share one program.

The export is one program, as the JAX package's jitted ``lax.scan``
(``neurec_tpu/recommend.py:156-190``): a prologue (the cursor zeroed, the
dense hook's all-users scores) and a body a batch that reads its users and
edges at a device cursor (``step_graph.at``), scores, sets the consumed
items to -inf by one fill at flat offsets (a pad's offset lies past the
block, as JAX's ``mode="drop"``), and writes its top-K into static
(n_batches, B, k) buffers; the host reads them once at the end. A model
whose ``predict`` takes an edge capacity (NAIS, DeepICF:
``predict_capacity``) gets the request's, rounded up to a power of two as
the edge count is. The programs are kept per live model in
``_EXPORT_CACHE``, keyed by (B, k, masked, use_dense), the batch, edge and
capacity counts and the kernels' routes (``step_graph.routes``), with a
weakref finalizer on the model and an LRU of ``_EXPORT_CACHE_MAX``; a
program holds the model weakly. On a CUDA device (``_captures``, and
``graphs``) a program is a
``step_graph.KeptProgram`` captured as CUDA graphs at its first call and
replayed by later ones; a call copies its users and edges into the
program's static inputs, and a program whose ``params`` leaves moved is
captured anew. Elsewhere the same program runs eagerly.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.ops.topk import top_k


class _Export(NamedTuple):
    """A kept export program, its static inputs and outputs, ``args``
    (``params`` during a run) and ``sig`` (``step_graph.signature`` of the
    params it was made for)."""

    program: step_graph.KeptProgram
    users_b: torch.Tensor
    e_items: torch.Tensor
    e_users: torch.Tensor
    scores: torch.Tensor
    items: torch.Tensor
    args: dict
    sig: tuple


_EXPORT_CACHE: "OrderedDict[tuple, _Export]" = OrderedDict()
_EXPORT_CACHE_MAX = 8


def _release(key) -> None:
    export = _EXPORT_CACHE.pop(key, None)
    if export is not None:
        export.program.release()


def _cache_get(model, sub_key) -> Optional[_Export]:
    key = (id(model), sub_key)
    export = _EXPORT_CACHE.get(key)
    if export is not None:
        _EXPORT_CACHE.move_to_end(key)
    return export


def _cache_put(model, sub_key, export: _Export) -> None:
    key = (id(model), sub_key)
    _release(key)
    _EXPORT_CACHE[key] = export
    mid = id(model)
    weakref.finalize(model, lambda mid=mid: [_release(k) for k in [k for k in _EXPORT_CACHE if k[0] == mid]])
    while len(_EXPORT_CACHE) > _EXPORT_CACHE_MAX:
        _release(next(iter(_EXPORT_CACHE)))


def _captures(model, device: torch.device) -> bool:
    """Whether the export runs as CUDA graphs kept across calls (unless
    the caller passes ``graphs=False``)."""
    return device.type == "cuda"


def _batch_edges_from_csr(csr, users_pad, n_valid, n_batches, B):
    """(edge_items, edge_users) (n_batches, E_max): batch j's consumed
    items as (item, local-slot) pairs, padded with slot == B; E_max a power
    of two, at least 8."""
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
    e_max = max(1 << int(within.max()).bit_length(), 8)  # a power of two > max index
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
    graphs: bool = True,
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
      graphs: False runs the program eagerly on the card too.

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

    masked = train_matrix is not None
    if masked:
        e_items, e_users = _batch_edges_from_csr(train_matrix.tocsr(), users_pad, n, n_batches, B)
    else:  # shape-stable dummies, as the JAX package's
        e_items, e_users = np.zeros((n_batches, 8), np.int32), np.full((n_batches, 8), B, np.int32)

    # dense-hoist hook: only for full-catalogue exports — a subset query
    # must not pay the all-users score matrix
    dense_hook = getattr(model, "eval_dense_scores", None)
    use_dense = callable(dense_hook) and n == model.num_users

    capacity = None
    if not use_dense and callable(getattr(model, "predict_capacity", None)):
        real = (np.arange(n_batches * B) < n).reshape(n_batches, B)
        capacity = max(1 << (model.predict_capacity(users_pad.reshape(n_batches, B), real) - 1).bit_length(), 8)
    capture = graphs and _captures(model, dev)
    sub_key = (B, k, masked, use_dense, n_batches, e_items.shape[1], capacity, capture, step_graph.routes())
    sig = step_graph.signature(params)
    export = _cache_get(model, sub_key)
    if export is None or export.sig != sig:
        export = _make_export(model, B, k, masked, use_dense, n_batches, e_items.shape[1], capacity, dev, capture,
                              sig)
        _cache_put(model, sub_key, export)
    export.users_b.copy_(torch.from_numpy(users_pad.reshape(n_batches, B)))
    export.e_items.copy_(torch.from_numpy(e_items))
    export.e_users.copy_(torch.from_numpy(e_users))
    export.args["params"] = params
    try:
        export.program.run(n_batches)
    finally:
        export.args["params"] = None
    items = export.items.reshape(-1, k).cpu().numpy()[:n]
    scores = export.scores.reshape(-1, k).cpu().numpy()[:n]
    return items.astype(np.int32), scores.astype(np.float32)


def _make_export(model, B, k, masked, use_dense, n_batches, e_max, capacity, dev, capture, sig) -> _Export:
    """The export program over static inputs (users, edge items, edge
    slots) and outputs (scores, ids), ``predict`` given ``capacity`` where
    it is not None; it reaches the model through a weak reference, so the
    cache does not keep the model alive."""
    sized = {} if capacity is None else {"capacity": capacity}
    model_ref = weakref.ref(model)
    num_items = model.num_items
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    users_b = torch.zeros((n_batches, B), dtype=torch.int64, device=dev)
    e_items = torch.zeros((n_batches, e_max), dtype=torch.int64, device=dev)
    e_users = torch.zeros((n_batches, e_max), dtype=torch.int64, device=dev)
    out_scores = torch.zeros((n_batches, B, k), dtype=torch.float32, device=dev)
    out_items = torch.zeros((n_batches, B, k), dtype=torch.int64, device=dev)
    args, tables = {"params": None}, {}

    def prologue():
        cursor.zero_()
        if use_dense:
            tables["dense"] = model_ref().eval_dense_scores(args["params"]).float()

    def body():
        bu, ei, eu = step_graph.at(cursor, users_b, e_items, e_users)
        scores = tables["dense"][bu] if use_dense else model_ref().predict(args["params"], bu, **sized).float()
        if masked:
            # one fill at flat offsets of a copy with one element past the
            # block: a pad pair (slot == B) writes there, as mode="drop"
            n = B * num_items
            flat = torch.empty(n + 1, dtype=torch.float32, device=dev)
            flat[:n].view(B, num_items).copy_(scores)
            flat.index_fill_(0, torch.where(eu < B, eu * num_items + ei, n), float("-inf"))
            scores = flat[:n].view(B, num_items)
        s, idx = top_k(scores, k)
        out_scores.index_copy_(0, cursor, s[None])
        out_items.index_copy_(0, cursor, idx[None])
        cursor.add_(1)

    program = step_graph.KeptProgram(prologue, body, dev, capture)
    return _Export(program, users_b, e_items, e_users, out_scores, out_items, args, sig)
