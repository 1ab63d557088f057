"""Functional model protocol + registry (port of ``neurec_tpu/models/base.py``).

A model is a description over a plain dict of tensors, keyed exactly as the
JAX package's params:

* ``init_params(generator) -> params``;
* ``predict(params, users) -> (B, num_items)`` full-catalogue scores;
* ``eval_embeddings(params, users) -> (u_vecs, item_table)`` where scores
  factor as ``u_vecs @ item_table.T`` (the evaluator then fuses scoring and
  masking in kernel K1);
* ``eval_tables(params) -> (user_table, item_table)`` where those tables
  are user-independent (the evaluator computes them once per call);
* ``loss(params, batch, weights) -> scalar`` — the per-batch training loss,
  differentiable in ``params``; ``batch`` keys depend on ``data_kind``:
    - "pairwise":       users, pos_items, neg_items
    - "pointwise":      users, items, labels
    - "time_pairwise":  users, recent_items, pos_items, neg_items
    - "time_pointwise": users, recent_items, items, labels
  ``weights`` masks padded instances (1 real / 0 pad).

A model lives on one device, chosen at construction (``device=None`` means
cuda, see ``device.py``). The Trainer (``trainer.py``) owns sampling, the
optimizer, the epoch loop and evaluation.

On a mesh whose 'model' axis is above 1 the Trainer places the leaves that
``param_shardings`` row-shards as this rank's blocks and tells the model
which (``place``, ``shards``); a model reaches a vocabulary-keyed leaf
only through ``rows`` (a lookup), ``rows_padded`` (a lookup where the pad
id, the row count, reads zeros), ``whole`` / ``whole_tree`` /
``with_whole`` (the whole table) and ``own_block`` (a table it writes
whole), the functions of ``parallel/tables.py``. Without a mesh they are
``leaf[ids]`` and ``leaf``.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.parallel import tables


class Recommender:
    """Base class: hyperparameter capture, device and protocol stubs."""

    data_kind: str = "pairwise"
    # the row-sharded leaves of the trainer's params: path -> tables.Shard
    shards: Dict[tuple, "tables.Shard"] = {}

    def __init__(self, dataset, config, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_users = dataset.num_users
        self.num_items = dataset.num_items
        self.batch_size = int(config.get("batch_size", 512))
        self.epochs = int(config.get("epochs", 100))
        self.verbose = int(config.get("verbose", 1))
        self.learner = config.get("learner", "adam")
        self.learning_rate = float(config.get("learning_rate", config.get("lr", 0.001)))
        self.num_negatives = int(config.get("num_negatives", 1))

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def predict(self, params, users) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, params, batch: Dict[str, torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # Whether a built-in epoch may split this model's steps over the mesh's
    # 'data' axis (``Trainer.dp_constrain``): each rank's loss is then its
    # rows' part, its terms over whole tensors and whole-batch counts taken
    # through ``parallel.mesh`` (``whole_term``, ``batch_sum``,
    # ``split_draw``). A model whose loss has no such form sets it False
    # and its step runs whole on every rank.
    dp_split: bool = True

    def take_steps(self, trainer, steps) -> torch.Tensor:
        """A custom epoch's run of steps (``step_graph.Steps``): through
        ``trainer`` (``Trainer.take_steps``: where it captures, the replays
        of the program it keeps under the run's key, ``steps.name``, from
        the epoch's first call on; the loss total summed over 'data' on a
        split run), or eagerly without one. Returns the summed step
        losses."""
        if trainer is None:
            return step_graph.take_steps(steps, self.device)
        return trainer.take_steps(steps)

    def on_mesh(self, mesh) -> None:
        """Hook: the Trainer announces its mesh before the first step.

        A model holding device-side structures re-places them (LightGCN and
        NGCF keep one row block of their adjacency per 'data' rank,
        ``ops/graph.py::maybe_shard``). Default: nothing to re-place.
        """
        return None

    def param_shardings(self, mesh, params=None):
        """A tree of ``parallel.mesh.Placement`` of ``init_params``' shape
        (of ``params``' when given, else of a fresh ``init_params``), as
        ``neurec_tpu/models/base.py::param_shardings`` lays its leaves out.

        Tensor parallelism is opt-out: every leaf with ndim >= 2 whose
        leading dimension is an id-vocabulary size (num_users / num_items,
        their +1 padded-row variants, or the num_users + num_items stacked
        graph) and divides the 'model' axis is row-sharded over 'model'
        (``row_sharded``); the rest, and every leaf under a 'model' axis of
        1, is replicated. The models look such a leaf up through ``rows``
        and use it whole through ``whole`` (``parallel/tables.py``).
        Returns None where the shapes cannot be had without data (a fresh
        ``init_params`` raises), as the JAX method does where its abstract
        evaluation fails."""
        from neurec_tpu_torch.bridge import map_params
        from neurec_tpu_torch.parallel.mesh import axis_size, replicated, row_sharded

        if params is None:
            try:
                params = self.init_params(torch.Generator(device=self.device).manual_seed(0))
            except Exception:
                return None
        n_model = axis_size(mesh, "model")
        vocab = {
            self.num_users,
            self.num_items,
            self.num_users + 1,
            self.num_items + 1,
            self.num_users + self.num_items,
        }

        def spec(leaf):
            if leaf.dim() >= 2 and leaf.shape[0] in vocab and n_model > 1 and leaf.shape[0] % n_model == 0:
                return row_sharded(mesh, leaf.dim())
            return replicated(mesh)

        return map_params(spec, params)

    # -- the 'model'-sharded tables ------------------------------------------
    def place(self, mesh, placements, params) -> None:
        """Keep which leaves of ``params`` (whole, before ``shard_params``)
        ``placements`` row-shards over 'model', so that ``rows`` and
        ``whole`` treat them as blocks (``Trainer.initialize``)."""
        self.shards = tables.table_shards(params, placements, mesh)

    def shard(self, path) -> Optional[tables.Shard]:
        """The ``tables.Shard`` of the leaf at ``path`` (a key, or a tuple of
        keys and list indices), None where the leaf is replicated."""
        return self.shards.get(path if isinstance(path, tuple) else (path,))

    def rows(self, params, path, ids: torch.Tensor) -> torch.Tensor:
        """``leaf[ids]`` of the vocabulary-keyed leaf at ``path``: an
        ID-partitioned lookup where the leaf is a 'model' block."""
        return tables.rows(_at(params, path), ids, self.shard(path))

    def rows_padded(self, params, path, ids: torch.Tensor) -> torch.Tensor:
        """``rows`` of the leaf at ``path`` with one zero row appended: the
        pad id (the leaf's row count) looks up zeros, as
        ``cat([leaf, 0])[ids]`` does. A sharded leaf needs no append: the
        pad id lies in no rank's block, so every rank gives zeros there."""
        leaf, shard = _at(params, path), self.shard(path)
        if shard is None:
            return torch.cat([leaf, leaf.new_zeros((1,) + tuple(leaf.shape[1:]))], dim=0)[ids]
        return tables.rows(leaf, ids, shard)

    def whole(self, params, path) -> torch.Tensor:
        """The whole of the vocabulary-keyed leaf at ``path``: its blocks
        gathered over 'model' where it is sharded, the leaf itself else."""
        return tables.whole(_at(params, path), self.shard(path))

    def own_block(self, path, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole value ``t`` of the leaf at
        ``path`` (a tensor of its own), ``t`` itself where the leaf is
        replicated: for a model that writes whole tables (WRMF's solved
        factors)."""
        shard = self.shard(path)
        return t if shard is None else tables.block_of(t, shard)

    def whole_tree(self, params, path=()):
        """The subtree of ``params`` at ``path`` (a dense tower, a list of
        layers) with each sharded leaf in it whole (``whole``), the others
        as they are."""
        prefix = path if isinstance(path, tuple) else (path,)
        sub = _at(params, prefix)
        if not any(p[: len(prefix)] == prefix for p in self.shards):
            return sub
        return tables.map_with_path(lambda p, v: tables.whole(v, self.shards.get(prefix + p)), sub)

    def with_whole(self, params, *keys):
        """``params`` (a dict) with the subtree under each of ``keys``
        through ``whole_tree``: for models whose vocabulary-keyed leaves
        are weight matrices used whole (the autoencoders' item layers)."""
        return dict(params, **{k: self.whole_tree(params, k) for k in keys})

    @staticmethod
    def _affine_eval(u_vecs, item_table, item_bias=None):
        """Fold a per-item bias into the factorized form by appending a
        constant-1 column to the user vectors."""
        if item_bias is None:
            return u_vecs, item_table
        ones = torch.ones((u_vecs.shape[0], 1), dtype=u_vecs.dtype, device=u_vecs.device)
        return (
            torch.cat([u_vecs, ones], dim=1),
            torch.cat([item_table, item_bias[:, None].to(item_table.dtype)], dim=1),
        )


def _at(params, path):
    for part in path if isinstance(path, tuple) else (path,):
        params = params[part]
    return params


def chunks(n: int, size: int):
    """``slice``s of at most ``size`` covering ``range(n)`` (the item or user
    chunks of a full-catalogue ``predict``)."""
    return [slice(lo, min(lo + size, n)) for lo in range(0, n, size)]


_REGISTRY: Dict[str, Type[Recommender]] = {}

_FAMILIES = ("general", "sequential", "social")


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def _import_families():
    import importlib

    for family in _FAMILIES:
        importlib.import_module("neurec_tpu_torch.models." + family)


def get_model(name: str) -> Type[Recommender]:
    """Resolve a model class by name, importing model families lazily."""
    if name not in _REGISTRY:
        _import_families()
    if name not in _REGISTRY:
        raise ImportError("Recommender '%s' is not found" % name)
    return _REGISTRY[name]


def registered_models():
    _import_families()
    return sorted(_REGISTRY)
