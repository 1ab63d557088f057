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
"""

from __future__ import annotations

from typing import Dict, Type

import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device


class Recommender:
    """Base class: hyperparameter capture, device and protocol stubs."""

    data_kind: str = "pairwise"

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

    def on_mesh(self, mesh) -> None:
        """Hook: the Trainer announces its mesh before the first step.

        A model holding device-side structures re-places them (LightGCN and
        NGCF keep one row block of their adjacency per 'data' rank,
        ``ops/graph.py::maybe_shard``). Default: nothing to re-place.
        """
        return None

    def param_shardings(self, mesh, params=None):
        """A tree of ``parallel.mesh.Placement`` of ``init_params``' shape
        (of ``params``' when given, else of a fresh ``init_params``):
        every leaf replicated, so every rank holds the whole of each table.
        Row-sharding the id tables over 'model' (the JAX package's default
        for a leaf whose leading dimension is a vocabulary size dividing the
        axis) is the next slice of the port; until then the tables stay
        whole, which changes memory and never a number."""
        from neurec_tpu_torch.bridge import map_params
        from neurec_tpu_torch.parallel.mesh import replicated

        if params is None:
            params = self.init_params(torch.Generator(device=self.device).manual_seed(0))
        return map_params(lambda _: replicated(mesh), params)

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
