"""The id tables row-sharded over 'model': ID-partitioned lookups by hand.

The port's own module, with no counterpart in the JAX package: there
``Recommender.param_shardings`` places every vocabulary-keyed table
row-sharded over the mesh's 'model' axis and GSPMD turns ``table[ids]``
into an ID-partitioned gather and a use of the whole table into an
all-gather. Here a rank at 'model' coordinate ``i`` holds rows ``[i*N/m,
(i+1)*N/m)`` of an N-row table as a tensor of its own (``Shard``), and the
models reach it through two autograd functions:

* ``rows(block, ids, shard)``, the lookup: forward, each rank gathers the
  ids that fall in its rows, zeros elsewhere, and the pieces are summed
  over 'model' (``all_sum``); a value plus zeros is exact, so the rows are
  ``table[ids]``'s bits. Backward: ``index_add_`` of the gradient rows
  whose ids are local into a zero block, with no collective;
* ``whole(block, shard)``, the whole table (full-catalogue scores, the
  graph propagation, whole-table regularisers, item-keyed weight
  matrices): forward, the blocks gathered over 'model'
  (``all_gather_rows``); backward, this rank's rows of the gradient, with
  no collective.

Neither backward needs a collective because every 'model' rank of one
'data' coordinate holds the same batch rows and the same replicated dense
weights: the upstream gradient is the same on all of them, and each keeps
the rows of its own block. The 'data' sum of ``Trainer.dp_sync_grads``
pairs ranks of one 'model' coordinate, which hold the same block.

A replicated leaf (``shard`` None) goes through both as ``block[ids]`` and
``block`` themselves, so a run without sharding keeps its bits. Every rank
of a 'model' group must make the same sequence of ``rows`` and ``whole``
calls (and of ``gather_tree``), or the group waits on the missing one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_sum


class Shard(NamedTuple):
    """This rank's block of a table row-sharded over 'model': rows ``[lo,
    lo + block)`` of the ``rows``-row whole."""

    mesh: Mesh
    lo: int
    block: int
    rows: int


def table_shards(params, placements, mesh: Mesh) -> Dict[tuple, Shard]:
    """The ``Shard`` of every leaf of ``params`` (whole, as every rank
    holds it before ``parallel.mesh.shard_params``) that ``placements``
    row-shards over 'model', by the leaf's path (``bridge.param_leaves``)."""
    out = {}
    if placements is None:
        return out
    for path, leaf in param_leaves(params):
        placement = placements
        for part in path:
            placement = placement[part]
        if placement.axis != "model":
            continue
        n = mesh.shape["model"]
        if placement.dim != 0 or leaf.shape[0] % n:
            raise ValueError("param %s: %s over 'model' (%d) is not a row block" % (path, tuple(leaf.shape), n))
        block = leaf.shape[0] // n
        out[path] = Shard(mesh, mesh.coordinate["model"] * block, block, int(leaf.shape[0]))
    return out


def _check(block: torch.Tensor, shard: Shard) -> None:
    if block.shape[0] != shard.block:
        raise ValueError("a table block of %d rows where this rank's block holds %d of %d (params not placed "
                         "with parallel.mesh.shard_params?)" % (block.shape[0], shard.block, shard.rows))


def _local(ids: torch.Tensor, shard: Shard):
    """``(local row, mine)`` of each id: its row in this rank's block and
    whether it lies there (a negative id counts from the end, as in
    ``table[ids]``)."""
    ids = torch.where(ids < 0, ids + shard.rows, ids) - shard.lo
    mine = (ids >= 0) & (ids < shard.block)
    return torch.where(mine, ids, torch.zeros_like(ids)), mine


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, ids, shard):
        local, mine = _local(ids, shard)
        got = block[local].masked_fill(~mine.reshape(mine.shape + (1,) * (block.dim() - 1)), 0)
        ctx.save_for_backward(local, mine)
        ctx.shard_block = block.shape
        return all_sum(got, shard.mesh, "model")

    @staticmethod
    def backward(ctx, grad):
        local, mine = ctx.saved_tensors
        shape = ctx.shard_block
        out = grad.new_zeros(shape)
        mine = mine.reshape(-1)
        out.index_add_(0, local.reshape(-1)[mine], grad.reshape((-1,) + tuple(shape[1:]))[mine])
        return out, None, None


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, shard):
        ctx.span = (shard.lo, shard.block)
        return all_gather_rows(block, shard.mesh, "model")

    @staticmethod
    def backward(ctx, grad):
        lo, n = ctx.span
        return grad[lo: lo + n].contiguous(), None


def rows(block: torch.Tensor, ids: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """``table[ids]`` of the table whose block this rank holds: an
    ID-partitioned gather (a collective over 'model') where ``shard`` is
    given, ``block[ids]`` where the leaf is replicated. A table that takes
    no gradient (ItemKNN's neighbour ids) has none here either."""
    if shard is None:
        return block[ids]
    _check(block, shard)
    return _Rows.apply(block, ids, shard)


def whole(block: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """The whole table: the blocks gathered over 'model' where ``shard`` is
    given, ``block`` itself where the leaf is replicated."""
    if shard is None:
        return block
    _check(block, shard)
    return _Whole.apply(block, shard)


def map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` applied to every leaf of ``tree`` (the params'
    structure: dicts stay dicts, lists and tuples become lists)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def gather(block: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole of a sharded table (or of a tensor blocked as one: its
    optimizer state) from this rank's ``block``: a collective, no
    gradient."""
    _check(block, shard)
    return all_gather_rows(block.detach(), shard.mesh, "model")


def gather_tree(tree, shards: Dict[tuple, Shard]):
    """``tree`` (structured as the params: the params themselves, or a
    moment of their optimizer) with every sharded leaf gathered whole over
    'model', detached; the other leaves as they are. A collective: every
    rank calls it."""
    if not shards:
        return tree
    return map_with_path(lambda path, leaf: leaf if path not in shards else gather(leaf, shards[path]), tree)


def block_of(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's block of the whole ``t``, a tensor that owns its storage
    (a view would keep the whole table alive)."""
    if t.shape[0] != shard.rows:
        raise ValueError("a table of %d rows where the sharded one has %d" % (t.shape[0], shard.rows))
    return t.detach()[shard.lo: shard.lo + shard.block].clone(memory_format=torch.contiguous_format)

