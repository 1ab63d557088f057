"""Evaluation masking/ranking tiers: one builder per tier plus a pure selector.

Port of ``neurec_tpu/eval/tiers.py``. ``select_tier`` is the JAX
package's pure function, copied as is; the builders:

``bits`` / ``bits_dp`` (DEFAULT)
    Per-eval-user train masks packed once into a global bit-plane table;
    scoring and masking run in kernel K1 (``masked_scores_bits``) for
    factorized models, in plain torch on ``predict``'s scores otherwise.
    ``bits_dp`` (a mesh with more than one rank): K1 on this rank's rows
    of the batch, the top-K ids all-gathered over 'data'.

``item_shard_bits`` (a 'model' axis above one, big catalogues or forced)
    Each 'model' rank scores and masks its item block ``[s*I_m,
    (s+1)*I_m)`` (``shard_bits_geometry``) in K1 against its own contiguous
    bits table, packed per block, takes a local top-K with global ids, and
    the candidates are all-gathered over 'model' and merged
    (``_merge_local_topk``); then over 'data' as ``bits_dp``.

``item_shard_rows`` (NEUREC_EVAL_PREMASK=0 with a 'model' axis)
    The same merge, K1's int8 mask from block-local train ids.

``pallas`` / ``pallas_dp`` (NEUREC_EVAL_PREMASK=0, factorized models)
    K1 on its own contract: int8 mask built from padded train rows
    (``masked_scores``); ``pallas_dp`` on this rank's rows, as ``bits_dp``.

``scatter`` (NEUREC_EVAL_PREMASK=0, other models)
    Concat a dump column, scatter -inf at the padded train rows, slice.

A ``bits`` plan whose table would pass the budget streams
(``plan.stream``): ``make_edge_pack`` packs each batch's train pairs on the
device into the table's layout, so the consumers above are unchanged.

All top-K here break ties to the lowest item id, as ``lax.top_k`` does.
A builder given a mesh takes this rank's rows of the batch (the evaluator
slices them) and returns the whole batch's ids, on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from neurec_tpu_torch.ops import masked_scores as k1
from neurec_tpu_torch.ops.masked_scores import bits_expand, pack_mask_bits, wrap_ids
from neurec_tpu_torch.ops.topk import top_k
from neurec_tpu_torch.parallel.mesh import all_gather_rows

# Prebuilt per-eval-user bits tables larger than this are streamed (packed
# per batch) instead of held resident.
BITS_TABLE_BUDGET = 512 * 1024 * 1024

# Memory the replicated evaluator may spend on ONE (B, I) f32 score block;
# ``item_shard_threshold`` derives the auto item-sharding threshold from it.
SCORE_BLOCK_BUDGET = 384 * 1024 * 1024

_LANE_ITEMS = 1024  # bit-packed width granularity


def _bits_budget() -> int:
    """Resident bits-table budget; NEUREC_EVAL_BITS_BUDGET (bytes) overrides."""
    import os

    env = os.environ.get("NEUREC_EVAL_BITS_BUDGET", "")
    return int(env) if env else BITS_TABLE_BUDGET


def item_shard_threshold(batch_size: int) -> int:
    """Catalogue size at which auto item-sharding engages."""
    return SCORE_BLOCK_BUDGET // (4 * max(int(batch_size), 1))


def global_bits_width(num_items: int) -> int:
    """Packed catalogue width for the replicated bits tiers (a multiple of
    1024, as in the JAX package, so both build identical tables)."""
    return num_items + ((-num_items) % _LANE_ITEMS)


def shard_bits_geometry(num_items: int, n_model: int):
    """(block, width) for the item-sharded bits layout."""
    block = -(-int(num_items) // int(n_model))
    block += (-block) % _LANE_ITEMS
    return block, block * int(n_model)


class TierPlan(NamedTuple):
    """Resolved evaluation strategy for one (evaluator, model) pair."""

    name: str
    kind: str  # 'factorized' | 'predict'
    bits: bool
    table: bool
    pack_block: Optional[int]
    bits_width: Optional[int]
    hoist: bool
    dp: bool
    item_shard: bool

    @property
    def stream(self) -> bool:
        return self.bits and not self.table


def _no_bits(name, kind, dp=False, item_shard=False):
    return TierPlan(
        name=name, kind=kind, bits=False, table=False, pack_block=None,
        bits_width=None, hoist=False, dp=dp, item_shard=item_shard,
    )


def select_tier(
    *,
    factorized: bool,
    has_tables: bool,
    pallas_ok: bool,
    n_model: int,
    has_data_axis: bool,
    mesh_size: int,
    item_shard_mode: str,  # 'auto' | 'on' | 'off'
    num_items: int,
    batch_size: int,
    n_test_users: int,
    premask: bool,
    neg_protocol: bool = False,
    bits_budget: Optional[int] = None,
) -> TierPlan:
    """Pure tier selection, identical to the JAX package's."""
    if bits_budget is None:
        bits_budget = _bits_budget()
    if neg_protocol:
        return _no_bits("scatter", "predict")

    shardable = factorized and n_model > 1 and has_data_axis
    engage_shard = shardable and (
        item_shard_mode == "on"
        or (
            item_shard_mode == "auto"
            and num_items >= item_shard_threshold(batch_size)
        )
    )

    if engage_shard and premask:
        block, width = shard_bits_geometry(num_items, n_model)
        fits = n_test_users * (width // 8) <= bits_budget
        return TierPlan(
            name="item_shard_bits", kind="factorized", bits=True,
            table=fits, pack_block=block, bits_width=width,
            hoist=has_tables, dp=True, item_shard=True,
        )
    if engage_shard and pallas_ok:
        return _no_bits("item_shard_rows", "factorized", dp=True, item_shard=True)

    if premask:
        width = global_bits_width(num_items)
        fits = n_test_users * (width // 8) <= bits_budget
        dp = factorized and mesh_size > 1 and has_data_axis
        return TierPlan(
            name="bits_dp" if dp else "bits",
            kind="factorized" if factorized else "predict",
            bits=True, table=fits, pack_block=width, bits_width=width,
            hoist=has_tables, dp=dp, item_shard=False,
        )

    if pallas_ok:
        dp = mesh_size > 1 and has_data_axis
        return _no_bits("pallas_dp" if dp else "pallas", "factorized", dp=dp)

    return _no_bits("scatter", "predict")


def make_edge_pack(pack_block: int, width: int):
    """The streamed tier's pack (``neurec_tpu/eval/evaluator.py:517-528``):
    fn(edge_items, edge_slots, B) -> (B, width/8) uint8, the bit planes the
    table would hold for the batch's users, from the batch's (item, slot)
    edges; an edge with slot >= B is dropped. One (B, width) byte mask, set
    by one fill at flat offsets (a dropped edge sets the byte past the
    mask: no boolean index, so no host sync), then ``pack_mask_bits``."""

    def pack(edge_items, edge_slots, B):
        n = B * width
        flat = torch.zeros(n + 1, dtype=torch.uint8, device=edge_items.device)
        at = torch.where(edge_slots < B, edge_slots * width + edge_items, n)
        flat.index_fill_(0, at.reshape(-1), 1)
        return pack_mask_bits(flat[:n].view(B, width), pack_block)

    return pack


# -- tier builders ----------------------------------------------------------
# Factorized builders return fn(u_vecs, item_table, mask) -> (B, K) top-K
# ids; predict builders return fn(scores, mask).

def _gather_batch(ids: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' rows of the batch's ids, in batch order ('data')."""
    return ids if mesh is None else all_gather_rows(ids, mesh, "data")


def make_bits_topk(K: int, width: int, num_items: int, mesh=None):
    """``bits`` / ``bits_dp``: K1 score + bit-plane mask, then top-K."""

    def topk_fn(u_vecs, item_table, bits):
        masked = k1.masked_scores_bits(u_vecs, item_table, bits, width, num_items)
        return _gather_batch(top_k(masked, K)[1], mesh)

    return topk_fn


def make_bits_predict_topk(K: int, width: int, num_items: int):
    """``bits`` for models without eval_embeddings: the same bit-plane
    mask applied to ``predict``'s scores."""

    def topk_fn(scores, bits):
        masked = torch.where(
            bits_expand(bits, width)[:, :num_items] != 0, float("-inf"),
            scores[:, :num_items],
        )
        return top_k(masked, K)[1]

    return topk_fn


def make_pallas_topk(K: int, mesh=None):
    """``pallas`` / ``pallas_dp``: K1 on padded train rows (int8 mask), then top-K."""

    def topk_fn(u_vecs, item_table, train_rows):
        return _gather_batch(top_k(k1.masked_scores(u_vecs, item_table, train_rows), K)[1], mesh)

    return topk_fn


def _merge_local_topk(masked: torch.Tensor, off: int, num_items: int, K: int, k_local: int, mesh) -> torch.Tensor:
    """The tail of both item-sharded tiers: the catalogue-pad guard, a
    local top-``k_local`` with global ids, the all-gather over 'model' and
    the merge.

    The tie rule lives here and only here: the candidates line up in
    (shard, local rank) order, so at equal scores the merge's top-K (lowest
    position first) keeps the lowest global id, as the replicated tier's
    top-K over the whole catalogue does.
    """
    gcol = torch.arange(masked.shape[1], device=masked.device) + off
    masked = torch.where(gcol[None, :] < num_items, masked, torch.full_like(masked, float("-inf")))
    vals, ids = top_k(masked, k_local)
    gids = ids + off
    B, n_model = vals.shape[0], mesh.shape["model"]
    vals_cat = all_gather_rows(vals, mesh, "model").reshape(n_model, B, k_local).transpose(0, 1).reshape(B, -1)
    gids_cat = all_gather_rows(gids, mesh, "model").reshape(n_model, B, k_local).transpose(0, 1).reshape(B, -1)
    return torch.gather(gids_cat, 1, top_k(vals_cat, K)[1])


def _item_block(item_table: torch.Tensor, off: int, rows: int) -> torch.Tensor:
    """Rows ``[off, off + rows)`` of the item table, zero rows past its end.

    The table is whole: a model whose item table is row-sharded over
    'model' gathers its parameter blocks (N/m rows) through ``whole``,
    and the tier cuts its own block (I_m rows, padded to the packing
    width) from that, where the JAX package's XLA reshards one layout to
    the other."""
    block = item_table[off: off + rows]
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_zeros((rows - block.shape[0], block.shape[1]))], dim=0)
    return block


def make_item_shard_bits_topk(K: int, mesh, num_items: int, pack_block: int, n_model: int):
    """``item_shard_bits``: fn(u_vecs, item_table, bits_block) on this
    rank's rows, ``bits_block`` (B_loc, I_m/8) from the rank's own table
    packed per block. K1 scores and masks the rank's (B_loc, I_m) item
    block, then ``_merge_local_topk``, then the rows over 'data'."""
    I_m = pack_block
    k_local = min(K, I_m)
    off = mesh.coordinate["model"] * I_m

    def topk_fn(u_vecs, item_table, bits_block):
        masked = k1.masked_scores_bits(u_vecs, _item_block(item_table, off, I_m), bits_block, I_m, I_m)
        return _gather_batch(_merge_local_topk(masked, off, num_items, K, k_local, mesh), mesh)

    return topk_fn


def make_item_shard_rows_topk(K: int, mesh, num_items: int):
    """``item_shard_rows``: K1's int8 mask on the rank's item block, from
    block-local train ids (ids outside the block map past it, where the
    mask build drops them), then the merge as ``item_shard_bits``."""
    n_model = mesh.shape["model"]
    I_m = -(-num_items // n_model)
    k_local = min(K, I_m)
    off = mesh.coordinate["model"] * I_m

    def topk_fn(u_vecs, item_table, train_rows):
        inside = (train_rows >= off) & (train_rows < off + I_m)
        local_rows = torch.where(inside, train_rows - off, torch.full_like(train_rows, 2 ** 30))
        masked = k1.masked_scores(u_vecs, _item_block(item_table, off, I_m), local_rows)
        return _gather_batch(_merge_local_topk(masked, off, num_items, K, k_local, mesh), mesh)

    return topk_fn


def make_scatter_topk(K: int, num_items: int):
    """``scatter``: concat a dump column, scatter -inf at the padded train
    rows (pads point at the dump column), slice. The scatter is one fill
    at flat offsets of the (B, num_items + 1) block, as
    ``build_train_mask`` writes its mask: a dropped id is sent past the
    block, so no boolean index reads the host."""

    def topk_fn(scores, train_rows):
        B = scores.shape[0]
        n = B * (num_items + 1)
        flat = torch.empty(n + 1, dtype=torch.float32, device=scores.device)
        ext = flat[:n].view(B, num_items + 1)
        ext[:, :num_items] = scores
        ext[:, num_items] = 0.0
        # as JAX's .at[] over the num_items + 1 columns: negative ids wrap,
        # ids past the dump column drop
        rows, keep = wrap_ids(train_rows, num_items + 1)
        slot = torch.arange(B, device=scores.device)[:, None] * (num_items + 1)
        flat.index_fill_(0, torch.where(keep, slot + rows, n).reshape(-1), float("-inf"))
        return top_k(ext[:, :num_items], K)[1]

    return topk_fn
