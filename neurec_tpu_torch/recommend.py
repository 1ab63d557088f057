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
the edge count is. The programs are kept in ``EXPORTS``, one
``step_graph.KeptStore`` a process (an LRU of 8), keyed by the model,
(B, k, masked, use_dense), the batch, edge and capacity counts; a program
holds the model weakly, and a finalizer on the model releases its
programs. On a CUDA device (``step_graph.captures``, and ``graphs``) a
program is a ``step_graph.KeptProgram`` captured as CUDA graphs at its
first call and replayed by later ones; a call copies its users and edges
into the program's static inputs, and a program whose ``params`` leaves
moved, or a kernel wrapper swapped (``step_graph.routes``), is captured
anew. Elsewhere the same program runs eagerly.

While tracing is on (``profiling``), a call is the span
``neurec.batch_topk`` (attribute ``captured``, the graphs a capture
made), with children ``neurec.serve.edges`` (the edges and the padding),
``neurec.serve.h2d`` (the three copies in; attribute ``h2d_bytes``, the
bytes of the device buffers they fill), the program's capture or replay,
and ``neurec.serve.read`` (the two reads back).
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from neurec_tpu_torch import profiling, step_graph
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.ops.topk import top_k


# the export programs of this process
EXPORTS = step_graph.KeptStore(most=8)


def _release_model(mid: int) -> None:
    for key in [key for key in EXPORTS if key[0] == mid]:
        EXPORTS.release(key)


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
    with profiling.span("neurec.batch_topk"):
        num_items = model.num_items
        k = min(int(k), num_items)
        if users is None:
            users = np.arange(model.num_users, dtype=np.int32)
        users = np.asarray(users, dtype=np.int32)
        n = len(users)
        B = min(batch_size, max(n, 1))
        n_batches = -(-n // B)

        masked = train_matrix is not None
        with profiling.span("neurec.serve.edges"):
            users_pad = np.zeros(n_batches * B, np.int32)
            users_pad[:n] = users
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
        capture = step_graph.captures(dev, graphs)
        key = (id(model), B, k, masked, use_dense, n_batches, e_items.shape[1], capacity, capture)
        with EXPORTS.use(key, lambda: step_graph.signature(params), lambda: _make_export(
                model, B, k, masked, use_dense, n_batches, e_items.shape[1], capacity, dev, capture)) as export:
            inputs = export.tensors
            with profiling.span("neurec.serve.h2d") as sp:
                if sp:
                    sp.attrs["h2d_bytes"] = inputs["users"].nbytes + inputs["e_items"].nbytes + inputs["e_users"].nbytes
                inputs["users"].copy_(torch.from_numpy(users_pad.reshape(n_batches, B)))
                inputs["e_items"].copy_(torch.from_numpy(e_items))
                inputs["e_users"].copy_(torch.from_numpy(e_users))
            out = export.run(n_batches, params)
        with profiling.span("neurec.serve.read"):
            items = out["items"].reshape(-1, k).cpu().numpy()[:n]
            scores = out["scores"].reshape(-1, k).cpu().numpy()[:n]
        return items.astype(np.int32), scores.astype(np.float32)


def _make_export(model, B, k, masked, use_dense, n_batches, e_max, capacity, dev, capture) -> step_graph.KeptProgram:
    """The export program over static inputs (users, edge items, edge
    slots) and outputs (scores, ids), ``predict`` given ``capacity`` where
    it is not None; it reaches the model through a weak reference, so the
    store does not keep the model alive."""
    sized = {} if capacity is None else {"capacity": capacity}
    model_ref = weakref.ref(model)
    weakref.finalize(model, _release_model, id(model))
    num_items = model.num_items
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    users_b = torch.zeros((n_batches, B), dtype=torch.int64, device=dev)
    e_items = torch.zeros((n_batches, e_max), dtype=torch.int64, device=dev)
    e_users = torch.zeros((n_batches, e_max), dtype=torch.int64, device=dev)
    out_scores = torch.zeros((n_batches, B, k), dtype=torch.float32, device=dev)
    out_items = torch.zeros((n_batches, B, k), dtype=torch.int64, device=dev)
    tables = {}

    def prologue(params):
        cursor.zero_()
        if use_dense:
            tables["dense"] = model_ref().eval_dense_scores(params).float()

    def body(params):
        bu, ei, eu = step_graph.at(cursor, users_b, e_items, e_users)
        scores = tables["dense"][bu] if use_dense else model_ref().predict(params, bu, **sized).float()
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

    return step_graph.KeptProgram(prologue, body, dev, capture, dict(
        users=users_b, e_items=e_items, e_users=e_users, scores=out_scores, items=out_items))
