"""The ('data', 'model') mesh on torch.distributed (port of
``neurec_tpu/parallel/mesh.py``).

The JAX package scales over a 2-D mesh: batches split over 'data', id
tables row-sharded over 'model', the rest replicated, and GSPMD makes the
sharded program compute the single-device function. Here that function is
kept by hand, one process per rank:

* every rank holds the full host value of the dataset, the seeds and each
  epoch's draws; of the parameters it holds the replicated leaves whole
  and, of each id table that ``Recommender.param_shardings`` row-shards
  over 'model', its block of rows, a tensor of its own (``shard_params``;
  the models reach the tables through ``parallel/tables.py``);
* a rank *takes* its slice of a batch, rows ``[r*B/n, (r+1)*B/n)`` of the
  whole batch (``slice_rows``); nothing is sent to it;
* the collectives run over one axis's process group: ``all_sum``,
  ``all_gather_rows`` and ``reduce_scatter_rows`` (an ``all_sum`` and the
  rank's rows: gloo has no reduce-scatter).

``Mesh.staged``: under gloo a CUDA tensor goes through the host on every
call (gloo's CUDA collectives are not all there); under NCCL it stays on
the card. One code path per backend, chosen from the mesh's group, never a
fallback taken on an error. An axis of size 1 runs no collective.

A data-parallel step (``Trainer``, the custom epochs) runs its loss inside
``batch_split``. Inside it the terms of a loss that are not sums over the
batch's rows read the context:

* ``split_draw``: a draw a loss makes at the batch's shape (dropout,
  corruption, the VAE's noise, CDAE's negatives) is drawn at the *whole*
  batch's shape from the step's generator and the rank keeps its rows, so
  the split step uses the single step's numbers;
* ``whole_term``: a term over whole tensors (a weight regulariser) counts
  on the first 'data' rank only;
* ``batch_sum``: the whole batch's value of a per-rank sum (the weight
  count a mean divides by, APR's batch gradient);
* ``split_mean``: a mean over the batch's rows taken on the rank's rows,
  as its share of the whole batch's mean.

Summed over 'data', the ranks' losses and gradients are then the whole
batch's.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


class Mesh:
    """A ('data', 'model') mesh over the ranks of the process group.

    ``shape`` maps each axis to its size, ``coordinate`` to this rank's
    index along it; rank ``d * n_model + m`` sits at (d, m). ``group(axis)``
    is the process group of the ranks that share this rank's other
    coordinate.
    """

    axis_names = AXES

    def __init__(self, device_mesh, n_data: int, n_model: int, backend: str):
        self.device_mesh = device_mesh
        self.backend = backend
        self.shape: Dict[str, int] = {"data": int(n_data), "model": int(n_model)}
        coord = device_mesh.get_coordinate()
        self.coordinate: Dict[str, int] = {"data": int(coord[0]), "model": int(coord[1])}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def staged(self, t: torch.Tensor) -> bool:
        """True where a collective on ``t`` goes through the host (gloo and
        a CUDA tensor)."""
        return self.backend == "gloo" and t.is_cuda

    def __repr__(self):
        return "Mesh(data=%d, model=%d, backend=%s, at=%s)" % (
            self.shape["data"], self.shape["model"], self.backend, self.coordinate)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, world: Optional[int] = None) -> Mesh:
    """A ('data', 'model') mesh over the group's ``world`` ranks (all of
    them when None); ``n_data`` None takes ``world // n_model``. Raises
    ``ValueError`` where n_data x n_model does not cover the ranks, as the
    JAX package's does for its devices, and ``RuntimeError`` where no
    process group is up (``distributed.initialize_multihost``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    n_model = int(n_model)
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError("mesh %dx%d does not cover %d devices" % (n_data, n_model, world))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize_multihost first")
    backend = dist.get_backend()
    device_mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (n_data, n_model), mesh_dim_names=AXES)
    return Mesh(device_mesh, n_data, n_model, backend)


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


# -- collectives over one axis ------------------------------------------------

def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.to("cpu", copy=True) if mesh.staged(t) else t.clone()


def all_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (a new tensor on ``t``'s
    device, no gradient)."""
    if mesh.shape[axis] == 1:
        return t.detach()
    buf = _to_wire(mesh, t)
    dist.all_reduce(buf, group=mesh.group(axis))
    return buf.to(t.device)


def all_sum_many(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """The sums of ``tensors`` over the ranks of ``axis`` in one collective
    (the tensors laid end to end): new tensors, no gradient."""
    if not tensors:
        return []
    flat = all_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh, axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' ``t`` (all of one shape) stacked along dim 0 in the
    axis's order (a new tensor, no gradient)."""
    n = mesh.shape[axis]
    if n == 1:
        return t.detach()
    buf = _to_wire(mesh, t.contiguous())
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return torch.cat(parts, dim=0).to(t.device)


def reduce_scatter_rows(t: torch.Tensor, mesh: Mesh, axis: str, block: int) -> torch.Tensor:
    """This rank's rows ``[i*block, (i+1)*block)`` of the sum of ``t`` over
    the axis, zero past ``t``'s rows (``t`` holds at most n * block rows):
    an ``all_sum`` and the rank's slice."""
    total = all_sum(t, mesh, axis)
    lo = mesh.coordinate[axis] * block
    out = total[lo: lo + block]
    if out.shape[0] < block:
        out = torch.cat([out, out.new_zeros((block - out.shape[0],) + tuple(out.shape[1:]))], dim=0)
    return out


def slice_rows(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's slice of ``t``'s leading dimension, which must divide
    the axis."""
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError("a leading dimension of %d does not divide the %r axis (%d)" % (t.shape[0], axis, n))
    k = t.shape[0] // n
    i = mesh.coordinate[axis]
    return t[i * k: (i + 1) * k]


# -- placements: the counterparts of the JAX package's NamedShardings ------

class Placement(NamedTuple):
    """How a value lies on the mesh: split along ``dim`` over ``axis``
    (blocks of ceil(size / n) rows), or whole on every rank (``axis`` None)."""

    axis: Optional[str] = None
    dim: int = 0


def batch_sharding(mesh: Mesh) -> Placement:
    """The leading dimension over 'data' (a batch)."""
    return Placement("data", 0)


def replicated(mesh: Mesh) -> Placement:
    return Placement(None, 0)


def row_sharded(mesh: Mesh, ndim: int = 2) -> Placement:
    """Dim 0 over 'model' (an embedding table)."""
    return Placement("model", 0)


def col_sharded(mesh: Mesh, ndim: int = 2) -> Placement:
    """The last dim over 'model' (an output projection)."""
    return Placement("model", ndim - 1)


def global_device_put(x, placement: Placement, mesh: Mesh, device=None) -> torch.Tensor:
    """This rank's piece of the full host value ``x`` (every rank holds
    it) under ``placement``, on ``device`` (``x``'s when None). A piece is a
    tensor that owns its storage, never a view: a view would keep the whole
    value alive on every rank."""
    t = torch.as_tensor(x)
    if placement.axis is not None:
        n, i = mesh.shape[placement.axis], mesh.coordinate[placement.axis]
        block = -(-t.shape[placement.dim] // n)
        t = t.detach().narrow(placement.dim, min(i * block, t.shape[placement.dim]),
                              max(0, min(block, t.shape[placement.dim] - i * block)))
        t = t.clone(memory_format=torch.contiguous_format)
    return t if device is None else t.to(device)


def shard_params(params, placements, mesh: Optional[Mesh] = None):
    """Place a param tree on the mesh: ``placements`` None leaves it as
    it is; otherwise a tree of ``Placement`` of ``params``' structure. A
    replicated leaf is the tensor itself (every rank holds it); a sharded
    one is this rank's block, a fresh leaf tensor that takes a gradient as
    the whole one did, so the optimizer built over the placed tree (and its
    state) holds blocks."""
    if placements is None:
        return params
    if isinstance(params, dict):
        return {k: shard_params(v, placements[k], mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, p, mesh) for v, p in zip(params, placements))
    if placements.axis is None:
        return params
    return global_device_put(params, placements, mesh).requires_grad_(params.requires_grad)


# -- the data-parallel step's context ----------------------------------------

class BatchSplit(NamedTuple):
    """A step split over 'data': this rank holds rows ``[index*k,
    (index+1)*k)`` of the whole batch, ``count`` ranks in all."""

    index: int
    count: int
    mesh: Mesh


# the split of the step whose loss runs in this context (None: a whole step)
_SPLIT: "contextvars.ContextVar[Optional[BatchSplit]]" = contextvars.ContextVar("batch_split", default=None)


@contextlib.contextmanager
def batch_split(split: Optional[BatchSplit]):
    """Run a loss (and its backward) as one rank's part of a split step;
    ``None`` runs it whole."""
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def current_split() -> Optional[BatchSplit]:
    return _SPLIT.get()


def split_draw(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for a draw whose leading dimension is the batch's:
    inside a split step, drawn at the whole batch's shape and cut to this
    rank's rows, so every rank's rows hold the single step's numbers."""
    split = _SPLIT.get()
    shape = tuple(shape)
    if split is None:
        return draw(shape)
    k = shape[0]
    return draw((k * split.count,) + shape[1:])[split.index * k: (split.index + 1) * k]


def whole_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term over whole tensors: counted on the first 'data' rank of
    a split step only (zero, with a zero gradient, on the others)."""
    split = _SPLIT.get()
    if split is None or split.index == 0:
        return x
    return x * 0.0


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The whole batch's value of ``x``, this rank's partial sum: summed
    over 'data' inside a split step, ``x`` itself outside. No gradient
    flows through the sum."""
    split = _SPLIT.get()
    if split is None:
        return x
    return all_sum(x, split.mesh, "data")


def split_mean(mean: torch.Tensor) -> torch.Tensor:
    """A mean over the batch's rows, taken on this rank's rows: inside a
    split step its share of the whole batch's mean (over the 'data' ranks,
    which hold as many rows each), ``mean`` itself outside."""
    split = _SPLIT.get()
    return mean if split is None else mean / split.count
