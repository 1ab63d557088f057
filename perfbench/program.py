"""The system under test, built for a cell: the port's model over the
benchmark's split, with the benchmark's weights; and the pieces every job
shares (a silent logger, the reference of the configuration, its counts).
"""

from __future__ import annotations

import gc
import importlib
import sys
import time
from typing import NamedTuple

import torch

from perfbench import data


class SilentLogger:
    """The Trainer's logger: it writes nothing (no ``log/`` grows)."""

    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


class Program(NamedTuple):
    split: data.Split
    dataset: object  # the port's in-memory dataset
    conf: object     # the port's config over the configuration's hyperparameters
    model: object


def reference(config: dict):
    """The configuration's plain reference: ``perfbench/reference/<name>.py``."""
    return importlib.import_module("perfbench.reference." + config["reference"])


def load_split(ctx) -> data.Split:
    return data.load(ctx.root, ctx.cell.config["data"])


def build(ctx, split: data.Split) -> Program:
    """The port's model of the configuration on ``ctx.device``."""
    from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
    from neurec_tpu_torch.models import get_model

    cfg = ctx.cell.config
    dataset = InMemoryDataset(split.train, split.test, name=cfg["dataset"])
    conf = DictConfig(dict(cfg["hyper"], recommender=cfg["model"]))
    model = get_model(cfg["model"])(dataset, conf, device=ctx.device)
    return Program(split, dataset, conf, model)


def weights(ctx, num_users: int, num_items: int) -> dict:
    """The cell's weights, drawn from ``--seed`` on the device by the
    reference's ``make_weights``: the same seed gives the same weights,
    to the program and again to the reference."""
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    return reference(ctx.cell.config).make_weights(ctx.cell.config["hyper"], num_users, num_items, gen)


def adjacency_nnz(config: dict, split: data.Split) -> int:
    """Edges of the normalized adjacency the configuration's propagation
    multiplies by: both directions of each train pair, and each node's
    self loop under ``norm``."""
    nnz = 2 * split.train.nnz
    if config["hyper"].get("adj_type", reference(config).ADJ_TYPE) == "norm":
        nnz += split.num_users + split.num_items
    return nnz


def free() -> None:
    """After the caller dropped the program's objects: collect them and
    return their memory before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)



class Phases:
    """Seconds of each phase of a set-up, each ended by a synchronize,
    printed to standard error (they say where set-up goes)."""

    def __init__(self, ctx):
        self.device, self.rows = ctx.device, [("imports", time.perf_counter() - ctx.t0)]
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.rows.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("setup phases: " + " ".join("%s=%.3f" % row for row in self.rows), file=sys.stderr)
