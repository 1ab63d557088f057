"""Checkpoint / resume (port of ``neurec_tpu/checkpoint.py``).

The reference has no saver at all; a crash loses the run. Here the training
state (params, optimizer state, the epoch) is written with ``torch.save``
after an epoch and restored to continue the run, on any device.

* A checkpoint is one file, ``<directory>/ckpt-<epoch>.pt``, holding only
  tensors (on the CPU), numbers, strings and containers, so it loads with
  ``torch.load(..., weights_only=True)`` wherever it was written.
* ``opt_state`` is the trainer's: a ``torch.optim.Optimizer``, a dict or
  list of them (CFGAN's ``{"g", "d"}``), ``{}`` (IRGAN) or ``None`` (WRMF).
  Each optimizer's ``state_dict()`` is saved in the tree's shape.
* ``restore`` copies into the caller's tensors (``params_like``) under
  ``no_grad`` (the file is read onto the CPU, so a checkpoint written on
  the card restores without one) and loads each optimizer of
  ``opt_state_like`` with ``load_state_dict``, and returns those same
  objects: the optimizers keep
  stepping the tensors the trainer holds. Tensors that take no gradient
  (ItemKNN's neighbour ids) are restored as they were. Adam's ``step`` stays
  a CPU f32 tensor (``torch.optim.Optimizer.load_state_dict`` keeps it as
  saved), so SRGNN's learning-rate decay resumes where it stopped.
* A write goes to a temporary file in the directory, is flushed to disk and
  renamed over its name (``os.replace``), so a crash never leaves a half
  written newest checkpoint; the newest ``max_to_keep`` are kept.
* Under a process group (a mesh, ``parallel/``) every rank first gathers
  each table row-sharded over 'model' (``shards``, the model's
  ``Recommender.shards``), and the optimizer state of that table
  (Adam's ``exp_avg`` and ``exp_avg_sq``), into whole host copies: the
  gathers are collectives. Then only the primary rank writes, and every
  rank waits at a barrier. A file therefore holds whole tensors only.
  Every rank restores its part of the host copies under the current
  mesh's placements: its block of each sharded table and of its optimizer
  state, the rest whole. So a run saved on one mesh shape resumes on
  another.

The format is the port's own: it does not read the JAX package's orbax
checkpoints (that would import jax). Weights cross between the packages as
numpy through ``bridge.py``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.parallel import tables
from neurec_tpu_torch.parallel.distributed import barrier, is_primary_host

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")
_OPT = "__optimizer_state_dict__"


def _to_cpu(tree):
    """A copy of ``tree`` (dicts, lists, tuples) with every tensor detached
    on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def _sharded_slots(opt: torch.optim.Optimizer, owners):
    """``(index in the state dict, param, Shard)`` of each of ``opt``'s
    params that is a sharded table's block (``owners``: id(param) ->
    Shard), in the state dict's order."""
    params = [p for group in opt.param_groups for p in group["params"]]
    return [(i, p, owners[id(p)]) for i, p in enumerate(params) if id(p) in owners]


def _whole_state(opt: torch.optim.Optimizer, owners) -> dict:
    """``opt.state_dict()`` with the state of every sharded param (each
    tensor of the param's shape: Adam's moments) gathered whole over
    'model'; a collective where ``owners`` holds a param."""
    sd = opt.state_dict()
    for i, p, shard in _sharded_slots(opt, owners):
        if i in sd["state"]:
            # a copy: the state dict's entries are the optimizer's own dicts
            sd["state"][i] = {k: tables.gather(v, shard) if isinstance(v, torch.Tensor) and v.shape == p.shape
                              else v for k, v in sorted(sd["state"][i].items())}
    return sd


def _blocked_state(opt: torch.optim.Optimizer, sd: dict, owners) -> dict:
    """A saved (whole) state dict with the state of every sharded param cut
    to this rank's block."""
    for i, p, shard in _sharded_slots(opt, owners):
        if i in sd["state"]:
            sd["state"][i] = {k: tables.block_of(v, shard) if isinstance(v, torch.Tensor)
                              and tuple(v.shape) == (shard.rows,) + tuple(p.shape[1:]) else v
                              for k, v in sd["state"][i].items()}
    return sd


def _opt_tree(opt_state, owners=None):
    """The optimizer tree with each optimizer as its ``state_dict()``,
    the state of sharded params whole (``_whole_state``)."""
    if isinstance(opt_state, torch.optim.Optimizer):
        return {_OPT: _to_cpu(_whole_state(opt_state, owners or {}))}
    if isinstance(opt_state, dict):
        return {k: _opt_tree(v, owners) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return [_opt_tree(v, owners) for v in opt_state]
    if opt_state is None:
        return None
    raise TypeError("cannot checkpoint optimizer state of type %s" % type(opt_state).__name__)


def _load_opt(like, saved, path="opt_state", owners=None):
    """Load ``saved`` (an ``_opt_tree``) into the optimizers of ``like``,
    the state of sharded params cut to this rank's blocks."""
    if isinstance(like, torch.optim.Optimizer):
        if not (isinstance(saved, dict) and _OPT in saved):
            raise ValueError("%s: the checkpoint holds no optimizer here" % path)
        like.load_state_dict(_blocked_state(like, saved[_OPT], owners or {}))
    elif isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError("%s: keys %s in the checkpoint, %s here" % (
                path, sorted(saved) if isinstance(saved, dict) else saved, sorted(like)))
        for k in like:
            _load_opt(like[k], saved[k], "%s[%r]" % (path, k), owners)
    elif isinstance(like, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(like):
            raise ValueError("%s: %d optimizers here, the checkpoint differs" % (path, len(like)))
        for i, (l, s) in enumerate(zip(like, saved)):
            _load_opt(l, s, "%s[%d]" % (path, i), owners)
    elif like is not None or saved is not None:
        raise ValueError("%s: %r here, %r in the checkpoint" % (path, like, type(saved).__name__))
    return like


class CheckpointManager:
    """``shards``: the 'model'-sharded tables of the params it saves and
    restores (``Recommender.shards``, path -> ``tables.Shard``); empty
    where every leaf is whole."""

    def __init__(self, directory: str, max_to_keep: int = 3, shards=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.shards = dict(shards or {})
        os.makedirs(self.directory, exist_ok=True)

    def _owners(self, params):
        """id(block) -> Shard of each sharded leaf of ``params``."""
        return {id(leaf): self.shards[path] for path, leaf in param_leaves(params) if path in self.shards}

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, "ckpt-%d.pt" % epoch)

    def all_epochs(self) -> List[int]:
        """The epochs of the checkpoints in the directory, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, params, opt_state, extra: Optional[dict] = None):
        """Write the state of ``epoch``: every rank gathers the sharded
        tables and their optimizer state, the primary rank alone writes,
        and every rank leaves after the write, at a barrier."""
        state = {
            "params": _to_cpu(tables.gather_tree(params, self.shards)),
            "opt_state": _opt_tree(opt_state, self._owners(params)),
            "epoch": int(epoch),
        }
        if is_primary_host():
            self._write(epoch, state, extra)
        barrier()

    def _write(self, epoch: int, state: dict, extra: Optional[dict]):
        if extra:
            state["extra"] = _to_cpu(extra)
        final = self.path(epoch)
        tmp = os.path.join(self.directory, ".ckpt-%d.pt.%d.tmp" % (epoch, os.getpid()))
        try:
            with open(tmp, "wb") as fout:
                torch.save(state, fout)
                fout.flush()
                os.fsync(fout.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_epochs()[: -self.max_to_keep]:
            os.unlink(self.path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def restore(self, params_like, opt_state_like, epoch: Optional[int] = None):
        """Restore ``(params, opt_state, epoch)`` into ``params_like`` (a
        tree of tensors, copied into in place) and ``opt_state_like`` (its
        optimizers loaded in place); returns those objects. The newest
        checkpoint unless ``epoch`` is given. The file is read onto the CPU
        (``map_location``, wherever it was written) and each param copied
        onto its tensor's device; ``load_state_dict`` places the optimizer
        state by its param (Adam's ``step`` stays on the CPU)."""
        step = epoch if epoch is not None else self.latest_epoch()
        if step is None:
            raise FileNotFoundError("no checkpoint found under %s" % self.directory)
        state = torch.load(self.path(step), map_location="cpu", weights_only=True)
        saved = dict(param_leaves(state["params"]))
        like = dict(param_leaves(params_like))
        if set(saved) != set(like):
            raise ValueError("the checkpoint's params %s are not these %s" % (sorted(saved), sorted(like)))
        with torch.no_grad():
            for path, dst in like.items():
                src = saved[path]
                if path in self.shards:
                    src = tables.block_of(src, self.shards[path])
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError("param %s: %s %s in the checkpoint, %s %s here"
                                     % (path, tuple(src.shape), src.dtype, tuple(dst.shape), dst.dtype))
                dst.copy_(src)
        _load_opt(opt_state_like, state["opt_state"], owners=self._owners(params_like))
        return params_like, opt_state_like, int(state["epoch"])

    def close(self):
        """Nothing to release (the writes are synchronous); kept for the JAX
        package's interface."""


def attach_to_trainer(trainer, directory: str, every: int = 1):
    """Wire periodic checkpointing and auto-resume into a Trainer.

    Returns the epoch to start from (1 if fresh). ``Trainer.train`` reads
    ``trainer._ckpt``, ``trainer._ckpt_every`` and ``trainer._start_epoch``.
    """
    if trainer.params is None:
        trainer.initialize()
    mgr = CheckpointManager(directory, shards=trainer.model.shards)
    trainer._ckpt = mgr
    trainer._ckpt_every = max(int(every), 1)
    start = 1
    if mgr.latest_epoch() is not None:
        trainer.params, trainer.opt_state, last = mgr.restore(trainer.params, trainer.opt_state)
        start = last + 1
    trainer._start_epoch = start
    return start
