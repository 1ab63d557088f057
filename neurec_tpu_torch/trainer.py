"""The training loop (port of ``neurec_tpu/trainer.py``).

The JAX package runs a whole epoch as one jitted ``lax.scan`` with
``scan_unroll`` steps an iteration, compiled once in ``initialize`` and
called every epoch; here an epoch's steps are one step function (a
built-in epoch's ``_step``, a custom epoch's from its model) that, on a
CUDA device, a ``step_graph.KeptSteps`` captures as CUDA graphs of
``scan_unroll`` steps at the first epoch and replays at every later one
(``take_steps``, the programs kept in ``Trainer.kept``), and that runs step
by step on the CPU (``Trainer(graphs=False)`` and a mesh of more than one
rank too).
``graphs`` reaches the evaluator too: its programs are CUDA graphs kept
across calls where the steps' are (``eval/evaluator.py``).
An epoch has two parts:

* ``draw_epoch(generator) -> (inst, w, negs, seeds)`` holds all of the
  epoch's randomness: a permutation of ``steps * B`` instance slots (slots
  past the instance count take instance 0 with weight 0), step by step one
  fresh negative per slot from the exclusion sampler (``ops/sampling.py``),
  and last one seed per step for what a model draws inside its loss
  (NGCF's dropout);
* ``run_epoch(params, opt_state, inst, w, negs, seeds, epoch)`` takes the
  steps: loss, backward, optimizer step; the epoch loss is sum(step
  losses) / steps. Step ``s`` gets a device generator seeded with
  ``seeds[s]`` as ``batch["generator"]`` (NGCF's and ConvNCF's dropout,
  APR's random perturbation) and the epoch number as ``batch["epoch"]``, a
  0-d device tensor (APR's ``adv_epoch`` switch), as the JAX package's
  steps get ``rng`` and a traced ``epoch``.

A test can therefore hand both packages the same draws. Epoch semantics
are the JAX package's (pairwise: every train positive once per epoch with
one negative; pointwise: ``1 + num_negatives`` instances per positive,
instance ``i`` being positive ``i % N`` and labelled 1 when ``i < N``).
The ``time_pairwise`` / ``time_pointwise`` epochs are the same over the
time-order instances (``_time_order_instances``, data/sampler.py:42-68:
the user, the ``high_order`` items before a position and the item at it),
and their batches also carry ``recent_items`` (B, high_order). The
log lines ("[iter %d : loss : %f, time: %f]", "epoch %d:\\t<results>") and
the ``.metrics.jsonl`` records are kept.

The other epochs (``neurec_tpu/trainer.py:138-160,425-475,507``):

* ``dense_row`` (the autoencoders): the instances are the users with train
  items, in sorted order; ``draw_epoch`` permutes ``steps * B`` slots and
  draws the step seeds (``negs`` is empty), and step ``s`` of ``run_epoch``
  hands the model ``{"users", "rows", "generator", "step"}``: the users'
  dense 0/1 train rows (the model's ``make_rows``) and the global step
  ``(epoch - 1) * steps + s``, on the device (MultiVAE's KL anneal);
* ``custom``: the model's ``build_epoch(trainer)`` returns its epoch,
  ``epoch(params, opt_state, generator, epoch, max_steps=None) -> (params,
  opt_state, loss)`` (WRMF's ALS, JCA's block grid, the GANs' sub-epochs,
  SBPR's, the sequential models' and GRU4Rec's schedule). Each run of its
  steps is a ``step_graph.Steps`` that the epoch hands to ``take_steps``
  (``Recommender.take_steps``), so it is captured and kept across epochs
  as a built-in epoch's is, under the run's name; its draws are made
  before the steps, a seed a step among them, and reach the steps as the
  run's ``inputs``.
  WRMF's epoch, one ALS solve, has no steps and runs eagerly;
* ``none``, as ``epochs == 0``: one evaluation, no training.

``Trainer.train_epoch(epoch, max_steps)`` runs one epoch from the trainer's
state; ``max_steps`` cuts it (a custom epoch: each of its passes) to its
first steps, for a short run at full width.

The optimizer is the configured learner's, or the model's own where it
defines ``make_optimizer`` (ConvNCF's two Adagrads) or ``init_opt_state``,
as in the JAX trainer: ``Trainer.init_opt_state(params)`` builds it.

Random streams: parameters are drawn from a generator seeded with
``seed``, epoch ``e`` from one seeded with ``(seed + 1, e)``. They are
torch's (Philox on a CUDA device), not JAX's threefry: the packages agree
in distribution, not draw for draw. A captured step draws from generators
registered with its graph and seeded before each replay, so it draws what
the eager step draws. ``scan_unroll`` (``--scan_unroll``, read as the JAX
trainer reads it) is the steps a graph holds.

The exclusion sampler: below ``_EXCL_TABLE_BUDGET`` the padded (U, L_max)
positive rows (``ops/sampling.py``, one step's negatives at a time); above
it, on every sampled epoch (the ``time_*`` ones included), the pair Bloom
filter (``ops/bloom.py``, k = 3, built on the host) and no padded table,
as in the JAX package (``neurec_tpu/trainer.py:162-194,284-340``).
``draw_epoch`` then pre-draws the whole epoch's negatives before the steps,
in chunks of ``_BLOOM_CHUNK`` slots by ``_bloom_rounds`` rounds (6 to 16,
from the densest user's row; see ``_rounds_for``), each chunk's candidates
from ``_bloom_draws``, on a generator of its own, seeded by a draw of the
epoch's generator that the step seeds do not share.

Data parallelism (``neurec_tpu/trainer.py:111-132,214-254``): with a
``mesh`` (``parallel/mesh.py``) every rank draws the whole epoch from the
same seeds and, in each step, takes its rows of the batch
(``dp_constrain``: rows ``[r*B/n, (r+1)*B/n)`` over the 'data' axis); the
loss runs inside ``parallel.mesh.batch_split``, so its draws, whole-tensor
terms and whole-batch counts are the single step's, and its gradients are
summed over 'data' (``dp_sync_grads``) before the optimizer, whose step is
then the same on every rank. The custom epochs split their steps the
same way through the trainer ``build_epoch`` receives (``dp_split_for``,
``dp_constrain``, ``dp_sync_grads``, ``dp_loss_total``). A batch whose
leading dimension does not divide the axis, or a model whose ``dp_split``
is False, runs whole on every rank, with the same result. Ranks along
'model' compute the same rows: they hold the same replicated parameters
and, of each id table that ``Recommender.param_shardings`` row-shards
over 'model', their own block (``place``); the models look the tables
up through ``parallel/tables.py``, whose backward leaves each rank the
gradient of its block, so the 'data' sum of ``dp_sync_grads`` pairs ranks
that hold the same block. Log lines and the ``.metrics.jsonl`` records
come from the primary rank only; the model's ``on_mesh`` hook runs at
construction.

Checkpoints and traces (``neurec_tpu/trainer.py:128-131,492-551``):
``checkpoint.attach_to_trainer`` sets ``_ckpt``, ``_ckpt_every`` and
``_start_epoch``; ``train`` then starts at ``_start_epoch``, saves every
``_ckpt_every`` epochs, and a run resumed at its final epoch still evaluates.
Epoch ``e``'s draws depend on ``e`` alone (``epoch_generator``, the
dense_row ``step``), so a resumed run on the CPU gives the uninterrupted
run's bits. ``trace_dir`` runs ``train`` inside ``profiling.device_trace``.
"""

from __future__ import annotations

import contextlib
import json
import time
from functools import partial
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.data.sequences import user_seq_windows
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.logging import Logger, run_logger
from neurec_tpu_torch.ops.bloom import build_pair_bloom, is_positive_bloom, select_first_nonmember
from neurec_tpu_torch.ops.sampling import sample_negatives
from neurec_tpu_torch.parallel.distributed import is_primary_host
from neurec_tpu_torch.parallel.mesh import (
    BatchSplit, Mesh, all_gather_rows, all_sum, all_sum_many, axis_size, shard_params, slice_rows,
)
from neurec_tpu_torch.profiling import device_trace
from neurec_tpu_torch.step_graph import KeptSteps, Steps, step_seeds, take_steps, train_step

# padded-exclusion-table byte budget: above it the sampled epochs exclude
# through the pair Bloom filter
_EXCL_TABLE_BUDGET = 64 * 1024 * 1024
# the Bloom filter's hashes (the probe gathers are the sampler's cost; a
# false positive only costs a rejection) and its false-positive rate at 8
# bits a pair, which sizes the rejection rounds
_BLOOM_K_HASH = 3
_BLOOM_FP = 0.031
# slots a pre-draw chunk takes at once: (chunk, rounds) draws and probes
_BLOOM_CHUNK = 8192

Params = Dict[str, object]  # a tree of dicts and lists of tensors (bridge.py)


_SAMPLED = ("pairwise", "pointwise", "time_pairwise", "time_pointwise")


class EpochDraws(NamedTuple):
    inst: torch.Tensor   # (steps, B) int32
    w: torch.Tensor      # (steps, B) f32
    negs: torch.Tensor   # (steps, B) int32; (steps, 0) on a dense_row epoch
    seeds: torch.Tensor  # (steps,) int64, on the host


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value=1e-8)``: acc += g^2;
    p -= lr * g * rsqrt(acc + eps) where acc > 0, else 0. (``torch.optim.Adagrad``
    puts eps outside the square root.)"""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 1e-8, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum_of_squares"]
                acc.add_(p.grad.square())
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
                p.add_(scale * p.grad, alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: nu = decay * nu + (1 - decay) * g^2 from nu = 0;
    p -= lr * g * rsqrt(nu + eps), eps inside the square root.
    (``torch.optim.RMSprop`` puts it outside.)"""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).add_(p.grad.square(), alpha=1.0 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


# b -> [1 - b^t for t = 1, 2, ...] in f32, each by numpy's scalar formula
# (a vectorized power differs from it in the last bit at some t)
_BIAS_CORRECTIONS: Dict[float, List[np.float32]] = {}


def bias_corrections(b: float, t0: int, n: int) -> np.ndarray:
    """``1 - b^t`` in f32 from an f32 ``b``, for t = t0 + 1 .. t0 + n: (n,)
    float32, each entry the scalar ``np.float32(1) - b ** np.float32(t)``."""
    done = _BIAS_CORRECTIONS.setdefault(float(b), [])
    bf = np.float32(b)
    for t in range(len(done) + 1, t0 + n + 1):
        done.append(np.float32(1.0) - bf ** np.float32(t))
    return np.asarray(done[t0:t0 + n], dtype=np.float32)


class _DeviceCount:
    """The step count of ``OptaxAdam.count_steps``: ``cursor`` (1,) int64 on
    the device counts the block's steps taken; ``tables`` holds, by key (a
    param group's index, SRGNN's ``("lr", index)``), a device table of
    ``rows`` rows and the function of ``n`` that gives its next ``n`` rows
    from the host counts; ``stepped`` the tensors stepped. A kept run keeps
    the count across its calls: ``refill`` puts each table's rows for the
    call's steps in place and zeroes the cursor, so that the graphs that
    read them read this call's."""

    def __init__(self, steps: int, most: Optional[int] = None):
        self.steps = steps
        self.rows = max(steps, most or 0)
        self.opened = False  # the block's first step() has run
        self.cursor: Optional[torch.Tensor] = None
        self.tables: Dict[object, tuple] = {}
        self.stepped: Dict[int, torch.Tensor] = {}

    def row(self, key, rows_of: Callable[[int], np.ndarray], device) -> torch.Tensor:
        """This step's row of table ``key``, read at the cursor on the
        device; the table is made at the block's first step from
        ``rows_of(steps)``."""
        entry = self.tables.get(key)
        if entry is None:
            first = rows_of(self.steps)
            table = torch.zeros((self.rows,) + first.shape[1:], dtype=torch.float32, device=device)
            table[:self.steps].copy_(torch.from_numpy(first))
            self.tables[key] = entry = (table, rows_of)
            if self.cursor is None:
                self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        return entry[0].index_select(0, self.cursor)[0]

    def refill(self, steps: int) -> None:
        """A new block of ``steps`` steps over the same tables."""
        if steps > self.rows:
            raise ValueError("a counted block of %d steps over tables of %d rows" % (steps, self.rows))
        self.steps = steps
        for table, rows_of in self.tables.values():
            table[:steps].copy_(torch.from_numpy(rows_of(steps)))
        if self.cursor is not None:
            self.cursor.zero_()


def _host_count(states) -> int:
    """The one host step count of a param group's states."""
    steps = {int(s["step"]) for s in states}
    if len(steps) != 1:
        raise ValueError("Adam state steps differ across parameters: %s" % sorted(steps))
    return steps.pop()


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam`` with optax's f32 arithmetic: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, bias corrections ``1 - b^t`` in f32 from an
    f32 ``b``, ``mu_hat / (sqrt(nu_hat) + eps)``, then
    ``p + (-lr) * update``. (``torch.optim.Adam`` computes ``1 - b^t`` in
    float64, ~2e-5 of a step away at t = 3.) The state keys are
    ``torch.optim.Adam``'s (``step``, ``exp_avg``, ``exp_avg_sq``), which
    ``bridge.adam_state_from_numpy`` / ``adam_state_to_numpy`` read and write;
    ``step`` is an f32 tensor on the host.
    One ``torch._foreach_*`` call per operation over the group's tensors.

    ``step()`` reads the count on the host and advances it, so a CUDA graph
    could not hold it. Inside ``count_steps(n)`` it changes no host state:
    the corrections come from a device table of the next ``n`` steps'
    (``bias_corrections``, built at the first step), indexed by a device
    count, and the host counts advance by ``n`` when the block ends. A kept
    run hands its count back each call, and the same tables are refilled
    in place for that call's steps."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self._count: Optional[_DeviceCount] = None

    @contextlib.contextmanager
    def count_steps(self, steps: int, count: Optional[_DeviceCount] = None, most: Optional[int] = None):
        """A block of ``steps`` calls of ``step()`` counted on the device
        (see the class docstring), yielding its count; ``count`` an earlier
        block's, whose tables are refilled for this one, else a fresh one
        whose tables hold ``max(steps, most)`` rows. The host counts of the
        tensors stepped in it advance by ``steps`` at its end."""
        if count is None:
            count = _DeviceCount(steps, most)
        else:
            count.refill(steps)
        self._count = count
        try:
            yield count
        finally:
            self._count = None
        for p in count.stepped.values():
            self.state[p]["step"] += steps

    def _corrections(self, gi: int, group, states, device):
        """The group's ``(1 - b1^t, 1 - b2^t)`` of this step: host floats, or
        0-d device tensors inside ``count_steps``."""
        count = self._count
        if count is None:
            t0 = _host_count(states)
            return float(bias_corrections(group["b1"], t0, 1)[0]), float(bias_corrections(group["b2"], t0, 1)[0])
        if gi not in count.tables:
            if count.opened:
                raise ValueError("Adam param group %d took no step at the start of a counted block" % gi)

        def rows_of(n):
            t0 = _host_count(states)
            return np.stack([bias_corrections(group["b1"], t0, n), bias_corrections(group["b2"], t0, n)], axis=1)
        row = count.row(gi, rows_of, device)
        return row[0], row[1]

    @torch.no_grad()
    def step(self, closure=None):
        count = self._count
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"step": torch.tensor(0.0, dtype=torch.float32),
                                     "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            states = [self.state[p] for p in params]
            bc1, bc2 = self._corrections(gi, group, states, params[0].device)
            grads = [p.grad for p in params]
            mus = [s["exp_avg"] for s in states]
            nus = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(mus, group["b1"])
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - group["b1"]))
            torch._foreach_mul_(nus, group["b2"])
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - group["b2"]))
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mus, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)
            if count is None:
                for s in states:
                    s["step"] += 1
            else:
                count.stepped.update((id(p), p) for p in params)
        if count is not None:
            count.opened = True
            if count.cursor is not None:
                count.cursor += 1


def make_optimizer(
    learner: str, learning_rate: float, momentum: float = 0.9
) -> Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]:
    """Optimizer factory with the reference's choices (util/learner.py:2-17)
    and optax's semantics: returns ``params -> torch.optim.Optimizer``.

    Gradients are dense, as in the JAX package: Adam's moments decay on
    every row at every step.
    """
    ln = learner.lower()
    if ln == "adagrad":
        return partial(OptaxAdagrad, lr=learning_rate)
    elif ln == "rmsprop":
        return partial(OptaxRMSprop, lr=learning_rate)
    elif ln == "adam":
        # b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias-corrected in f32
        return partial(OptaxAdam, lr=learning_rate)
    elif ln == "gd":
        return partial(torch.optim.SGD, lr=learning_rate)
    elif ln == "momentum":
        # t = g + m * t; p -= lr * t: optax.sgd(momentum=m)
        return partial(torch.optim.SGD, lr=learning_rate, momentum=momentum)
    raise ValueError("please select a suitable optimizer")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _flat_interactions(user_dict):
    users, items = [], []
    for u, its in user_dict.items():
        users.extend([u] * len(its))
        items.extend(its)
    return np.asarray(users, dtype=np.int32), np.asarray(items, dtype=np.int32)


def _rounds_for(d_max: float) -> int:
    """Rejection rounds of the Bloom pre-draw for the densest user's
    density ``d_max``: a positive is kept when every round is flagged and
    the round-0 draw is a positive, probability (d + FP)^R d / (d + FP);
    R is the least count in [6, 16] that puts it under 1e-8 at d_max."""
    rounds = 6
    while rounds < 16 and (d_max + _BLOOM_FP) ** rounds * max(d_max, 1e-12) / (d_max + _BLOOM_FP) > 1e-8:
        rounds += 1
    return rounds


def _time_order_instances(user_dict, high_order: int):
    """(user, recent[high_order], target) instances in the dict's order
    (data/sampler.py:42-68): each position ``idx >= high_order`` of a
    user's time-ordered items, with the ``high_order`` items before it."""
    keys = np.fromiter(user_dict.keys(), dtype=np.int32, count=len(user_dict))
    idx, recents, targets = user_seq_windows(list(user_dict.values()), high_order)
    return keys[idx], recents.reshape(len(idx), high_order), targets


class _SilentLogger:
    """The logger of a rank other than the primary: it writes nothing."""

    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


class Trainer:
    def __init__(
        self,
        model,
        dataset,
        config,
        logger: Optional[Logger] = None,
        seed: int = 2018,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
        graphs: bool = True,
    ):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError("the model lives on %s, the trainer on %s" % (model.device, self.device))
        # --trace_dir=<dir>: a torch.profiler trace of the run (profiling.py)
        get_raw = getattr(config, "get_raw", config.get)
        self.trace_dir = get_raw("trace_dir", None) or None
        kind = model.data_kind
        if kind not in _SAMPLED + ("dense_row", "custom", "none"):
            raise ValueError("Trainer does not handle data_kind=%r" % kind)
        self.model = model
        self.dataset = dataset
        self.config = config
        self.seed = seed
        self.mesh = mesh
        # every epoch's steps as CUDA-graph replays on a CUDA device, captured
        # once and kept across epochs (take_steps), ``scan_unroll`` steps a
        # graph, read as the JAX trainer reads it; the evaluator's programs
        # as graphs kept across calls
        self.graphs = graphs
        self.scan_unroll = max(int(config.get("scan_unroll", 1) or 1), 1)
        self._dp_warned = set()
        if mesh is not None and not is_primary_host():
            self.logger = _SilentLogger()
        else:
            self.logger = logger or run_logger(config, dataset.dataset_name)
        self.evaluator = Evaluator.from_dataset(dataset, config, device=self.device, mesh=mesh, graphs=graphs)
        if mesh is not None:
            model.on_mesh(mesh)
        # the optimizer factory: over the tensors of params (the learner's),
        # or over params itself (a model's make_optimizer); see init_opt_state
        if hasattr(model, "make_optimizer"):
            self.tx = model.make_optimizer()
        else:
            self.tx = make_optimizer(model.learner, model.learning_rate)

        self._pairwise = kind in ("pairwise", "time_pairwise")
        self._dense_row = kind == "dense_row"
        self._recent_flat = None
        self._excl_bloom = None
        self._bloom_rounds = None
        self.n_positives = self.n_instances = self.steps = 0
        if kind in _SAMPLED + ("dense_row",):
            time_order = kind.startswith("time_")
            user_dict = dataset.get_user_train_dict(by_time=time_order)
            if self._dense_row:
                # the instances are the users with train items, sorted
                users = np.asarray(sorted(user_dict.keys()), dtype=np.int32)
                self.n_instances = len(users)
            else:
                if time_order:
                    users, recent, pos = _time_order_instances(user_dict, getattr(model, "high_order", 1))
                    self._recent_flat = torch.from_numpy(recent).long().to(self.device)
                else:
                    users, pos = _flat_interactions(user_dict)
                self._pos_flat = torch.from_numpy(pos).long().to(self.device)
                self.n_positives = len(users)
                # pointwise epochs visit each positive (1 + num_negatives) times
                self.n_instances = self.n_positives * (1 if self._pairwise else 1 + model.num_negatives)
                self._build_exclusion(dataset.train_matrix)
            self._users_flat = torch.from_numpy(users).long().to(self.device)
            self.steps = _cdiv(self.n_instances, model.batch_size)
        self.params: Optional[Params] = None
        self.opt_state = None
        self._epoch_fn: Optional[Callable] = None
        # the runs of steps captured where the trainer captures, kept for its
        # life by run name (Steps.name): the built-in epoch, each custom pass
        self.kept: Dict[str, KeptSteps] = {}

    def _build_exclusion(self, train_matrix) -> None:
        """The sampler's exclusion: the padded positive rows, or the pair
        Bloom filter where they would pass ``_EXCL_TABLE_BUDGET``."""
        lens = np.diff(train_matrix.indptr)
        l_max = max(int(lens.max()) if len(lens) else 0, 8)
        padded_bytes = 4 * self.model.num_users * (l_max + (-l_max) % 8)
        if padded_bytes <= _EXCL_TABLE_BUDGET:
            padded = build_padded_positives(train_matrix)
            self._padded_items = torch.from_numpy(padded.items).to(self.device)
            return
        coo = train_matrix.tocoo()
        bf = build_pair_bloom(coo.row, coo.col, k_hash=_BLOOM_K_HASH)
        self._excl_bloom = (torch.from_numpy(bf.table).to(self.device), bf.n_bits, bf.k_hash)
        self._bloom_rounds = _rounds_for(float(lens.max() if len(lens) else 0) / max(self.model.num_items, 1))
        self.logger.info(
            "sampler exclusion: pair Bloom filter (%.1f MB, %d pairs, %d rounds) - padded rows would cost %.1f MB"
            % (bf.nbytes() / 2**20, coo.nnz, self._bloom_rounds, padded_bytes / 2**20))

    def _bloom_draws(self, generator: torch.Generator, shape) -> torch.Tensor:
        """One pre-draw chunk's candidates: int32 uniform in [0, num_items)."""
        return torch.randint(0, self.model.num_items, tuple(shape), generator=generator, device=generator.device,
                             dtype=torch.int32)

    def bloom_negatives(self, generator: torch.Generator, users: torch.Tensor) -> torch.Tensor:
        """One negative per entry of ``users`` (n,), drawn through the Bloom
        filter in chunks of ``_BLOOM_CHUNK`` by ``_bloom_rounds`` rounds
        (the users padded with user 0 to whole chunks): int32 (n,)."""
        table, n_bits, k_hash = self._excl_bloom
        n = users.shape[0]
        chunks = _cdiv(n, _BLOOM_CHUNK)
        u_pad = torch.zeros(chunks * _BLOOM_CHUNK, dtype=users.dtype, device=users.device)
        u_pad[:n] = users
        out = []
        for c in range(chunks):
            users_c = u_pad[c * _BLOOM_CHUNK:(c + 1) * _BLOOM_CHUNK]
            draws = self._bloom_draws(generator, (_BLOOM_CHUNK, self._bloom_rounds))
            out.append(select_first_nonmember(draws, is_positive_bloom(table, n_bits, users_c, draws, k_hash)))
        return torch.cat(out)[:n] if out else torch.zeros(0, dtype=torch.int32, device=users.device)

    # -- one epoch ----------------------------------------------------------
    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The generator of epoch ``epoch``'s draws, seeded from (seed + 1, epoch)."""
        seed = int(np.random.SeedSequence([self.seed + 1, epoch]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def draw_epoch(self, generator: torch.Generator) -> EpochDraws:
        """All of one epoch's randomness: ``inst`` (steps, B) int32 instance
        ids, ``w`` (steps, B) f32 weights (0 on pad slots), ``negs``
        (steps, B) int32, one fresh negative per slot, drawn step by step,
        and ``seeds`` (steps,) int64 on the host, one per step for the
        randomness a model draws inside its loss (dropout). The seeds are
        drawn last, so the first three do not depend on them. A dense_row
        epoch draws no negatives: ``negs`` is (steps, 0). Under the Bloom
        filter the negatives are one pre-draw over every slot
        (``bloom_negatives``), on a generator seeded by one draw of this one."""
        B, steps = self.model.batch_size, self.steps
        perm = torch.randperm(steps * B, generator=generator, device=self.device)
        valid = perm < self.n_instances
        inst = torch.where(valid, perm, torch.zeros_like(perm)).to(torch.int32).reshape(steps, B)
        w = valid.to(torch.float32).reshape(steps, B)
        if self._dense_row:
            negs = torch.zeros((steps, 0), dtype=torch.int32, device=self.device)
        elif self._excl_bloom is not None:
            # the whole epoch's negatives before the steps, on a generator of
            # their own (the step seeds below are other draws of this one)
            pre_seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=self.device))
            pre = torch.Generator(device=self.device).manual_seed(pre_seed)
            users = self._users_flat[self._base(inst)].reshape(-1)
            negs = self.bloom_negatives(pre, users).reshape(steps, B)
        else:
            users = self._users_flat[self._base(inst)]
            negs = torch.stack([
                sample_negatives(generator, self._padded_items[users[s]], self.model.num_items, ())
                for s in range(steps)
            ])
        return EpochDraws(inst, w, negs, step_seeds(generator, steps))

    def _base(self, inst: torch.Tensor) -> torch.Tensor:
        return (inst if self._pairwise or self._dense_row else inst % self.n_positives).long()

    def _batch(self, inst: torch.Tensor, negs: torch.Tensor) -> Dict[str, torch.Tensor]:
        base = self._base(inst)
        if self._dense_row:
            users = self._users_flat[base]
            return {"users": users, "rows": self.model.make_rows(users)}
        users, pos, negs = self._users_flat[base], self._pos_flat[base], negs.long()
        if self._pairwise:
            batch = {"users": users, "pos_items": pos, "neg_items": negs}
        else:
            is_pos = inst < self.n_positives
            batch = {"users": users, "items": torch.where(is_pos, pos, negs), "labels": is_pos.to(torch.float32)}
        if self._recent_flat is not None:
            batch["recent_items"] = self._recent_flat[base]
        return batch

    def run_epoch(self, params: Params, opt_state: torch.optim.Optimizer, inst, w, negs, seeds=None,
                  epoch: int = 1):
        """One step per row of ``inst`` / ``w`` / ``negs``; returns
        ``(params, opt_state, mean step loss)``. ``opt_state`` is the
        optimizer over the tensors of ``params``, which it updates in place.
        With ``seeds``, step ``s`` hands the model a ``torch.Generator`` on
        the device seeded with ``seeds[s]``, as ``batch["generator"]`` (the
        JAX package's per-step ``batch["rng"]``); without, the batch has
        none and a model draws nothing (no dropout). Every batch carries
        ``epoch`` (1-based) as ``batch["epoch"]``, a 0-d int64 tensor on the
        device, and on a dense_row epoch the global step
        ``(epoch - 1) * self.steps + s`` as ``batch["step"]``, computed on
        the device from it.

        The steps are ``_step`` driven by ``take_steps``. The JAX trainer
        compiles its epoch once and calls it every epoch with the epoch as
        a traced argument; here, on a CUDA device, the epoch's steps are a
        ``step_graph.KeptSteps`` that this trainer captures at its first
        call (step 0 eagerly, then graphs of ``scan_unroll`` steps) and
        replays at every later one, over buffers into which each call
        copies its ``inst``, ``w``, ``negs`` and epoch. They run eagerly on
        the CPU, with ``Trainer(graphs=False)`` and on a mesh of more than
        one rank (gloo stages every collective through the host, which a
        graph cannot hold). A loss must therefore synchronise nothing with
        the host, read the epoch and step only as device tensors and draw
        only from ``batch["generator"]``. The gradients are released at
        the end (``set_to_none``): a captured epoch's live in the graphs'
        memory pool."""
        steps = inst.shape[0]
        split = self.dp_split_for(inst.shape[1])
        epoch_t = torch.tensor(epoch, dtype=torch.int64, device=self.device)

        def make(cursor, total, inst, w, negs, epoch):
            return partial(self._step, params, opt_state, (inst, w, negs), cursor, total, split, epoch)

        inputs = dict(inst=inst, w=w, negs=negs, epoch=epoch_t)
        total = self.take_steps(Steps(make, steps, seeds, opt_state, split, inputs=inputs, reads=params))
        return params, opt_state, total / steps

    def take_steps(self, steps: Steps) -> torch.Tensor:
        """A run of steps as this trainer runs them: where it captures
        (``_captures``), the ``step_graph.KeptSteps`` it keeps under
        ``steps.name``, captured at the run's first call and replayed at
        every later one while it holds (``KeptSteps.holds``), else captured
        anew; eagerly elsewhere (``step_graph.take_steps``). Returns the
        summed step losses, over 'data' on a split run. ``run_epoch`` and
        the custom epochs (``Recommender.take_steps``) take their steps
        here."""
        if not self._captures():
            return self.dp_loss_total(take_steps(steps, self.device), steps.split)
        kept = self.kept.get(steps.name)
        if kept is not None and not kept.holds(steps, self.scan_unroll):
            self.release_kept(steps.name)
            kept = None
        if kept is None:
            kept = self.kept[steps.name] = KeptSteps(steps, self.device, self.scan_unroll)
        try:
            total = kept.run(steps)
        except BaseException:
            self.release_kept(steps.name)
            raise
        return self.dp_loss_total(total, steps.split)

    def release_kept(self, name: Optional[str] = None) -> None:
        """Release the kept run ``name`` (every kept run without one): its
        graphs, their pool and its buffers."""
        for key in [name] if name is not None else list(self.kept):
            kept = self.kept.pop(key, None)
            if kept is not None:
                kept.release()

    def _captures(self) -> bool:
        """Whether ``take_steps`` runs its steps as CUDA-graph replays: on a
        CUDA device, with ``graphs``, without a mesh of more than one rank."""
        return self.graphs and self.device.type == "cuda" and (self.mesh is None or self.mesh.size == 1)

    def _step(self, params: Params, opt_state, xs, cursor: torch.Tensor, total: torch.Tensor,
              split: Optional[BatchSplit], epoch: torch.Tensor, generator: Optional[torch.Generator]) -> None:
        """One training step, the one at ``cursor`` (a (1,) int64 device
        index into the rows of ``xs = (inst, w, negs)``) of epoch ``epoch``
        (a 0-d int64 device tensor): the batch, the loss, its backward and
        the optimizer's step; the loss is added to ``total`` and ``cursor``
        advanced, on the device. It synchronises nothing with the host and
        reads no Python value that changes from step to step or from epoch
        to epoch, so a CUDA graph kept across epochs can hold it."""
        inst_s, w_s, negs_s = (a.index_select(0, cursor)[0] for a in xs)
        if split is not None:  # this rank's rows of the step
            inst_s, w_s, negs_s = self.dp_constrain(inst_s, w_s, negs_s)
        batch = self._batch(inst_s, negs_s)
        batch["epoch"] = epoch
        if self._dense_row:
            batch["step"] = (epoch - 1) * self.steps + cursor[0]
        if generator is not None:
            batch["generator"] = generator
        train_step(lambda: self.model.loss(params, batch, w_s), opt_state, cursor, total, self, split, params)

    # -- data parallelism ---------------------------------------------------
    def dp_constrain(self, *arrays):
        """This rank's rows of each tensor over the mesh's 'data' axis.

        The JAX package pins a batch's leading dimension to ``P('data')``
        (``neurec_tpu/trainer.py:214-254``); here each rank takes rows
        ``[r*k, (r+1)*k)``, ``k = shape[0] / n_data``, of the whole-batch
        tensor every rank holds. A tensor whose leading dimension does not
        divide the axis stays whole, with a warning once per (dim, axis) on
        the primary rank. Without a mesh, or with one 'data' rank, the
        tensors come back as they are. One tensor in, one out."""
        n_data = axis_size(self.mesh, "data")
        out = []
        for x in arrays:
            if n_data > 1 and isinstance(x, torch.Tensor) and x.dim() >= 1:
                if x.shape[0] % n_data == 0:
                    x = slice_rows(x, self.mesh, "data")
                else:
                    self._warn_nondivisible(int(x.shape[0]), n_data)
            out.append(x)
        return tuple(out) if len(out) != 1 else out[0]

    def _warn_nondivisible(self, dim: int, n_data: int) -> None:
        key = (dim, n_data)
        if key in self._dp_warned:
            return
        self._dp_warned.add(key)
        if is_primary_host():
            self.logger.warning(
                "dp_constrain: batch leading dim %d does not divide the 'data' mesh axis (%d); data "
                "parallelism for this tensor is left to GSPMD propagation. Pick a batch_size divisible by "
                "the 'data' axis to guarantee DP." % key)

    def dp_split_for(self, rows: int) -> Optional[BatchSplit]:
        """The split of a step of ``rows`` batch rows over 'data', or None
        where the step runs whole: no mesh, one 'data' rank, a model whose
        ``dp_split`` is False, or ``rows`` not dividing the axis (warned,
        as ``dp_constrain`` warns)."""
        n_data = axis_size(self.mesh, "data")
        if n_data <= 1 or not self.model.dp_split:
            return None
        if rows % n_data:
            self._warn_nondivisible(int(rows), n_data)
            return None
        return BatchSplit(self.mesh.coordinate["data"], n_data, self.mesh)

    def dp_sync_grads(self, params: Params, split: Optional[BatchSplit]) -> None:
        """After a split step's backward: each gradient summed over 'data'
        (one collective over the gradients laid end to end), so that every
        rank holds the whole batch's. Every rank ran the same loss, so the
        same leaves have a gradient. Nothing to do for a whole step."""
        if split is None:
            return
        grads = [p.grad for _, p in param_leaves(params) if isinstance(p, torch.Tensor) and p.grad is not None]
        for g, total in zip(grads, all_sum_many(grads, split.mesh, "data")):
            g.copy_(total)

    def dp_loss_total(self, total: torch.Tensor, split: Optional[BatchSplit]) -> torch.Tensor:
        """A split epoch's summed step losses over 'data': the whole
        batches' (each rank's loss is its rows' part)."""
        return total if split is None else all_sum(total, split.mesh, "data")

    def dp_gather(self, x: torch.Tensor, split: Optional[BatchSplit]) -> torch.Tensor:
        """The ranks' rows of a split computation back in batch order, on
        every rank (WRMF's solved rows); ``x`` itself for a whole one."""
        return x if split is None else all_gather_rows(x, split.mesh, "data")

    # -- epochs, logs and evaluation ---------------------------------------
    def initialize(self):
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        # index tables among the params (ItemKNN's neighbour ids) take no gradient
        self.params = map_params(lambda v: v.detach().requires_grad_(v.is_floating_point()),
                                 self.model.init_params(generator))
        if self.mesh is not None:
            self.params = self.place(self.params, self.model.param_shardings(self.mesh, self.params))
        self.opt_state = self.init_opt_state(self.params)
        if self.model.data_kind == "custom":
            self._epoch_fn = self.model.build_epoch(self)

    def place(self, params: Params, placements) -> Params:
        """``params`` (whole, as every rank holds them) placed on the mesh:
        each leaf that ``placements`` row-shards over 'model' becomes this
        rank's block (``parallel.mesh.shard_params``), and the model keeps
        which (``Recommender.place``). Without a mesh, ``params`` as they
        are."""
        if self.mesh is None:
            return params
        self.model.place(self.mesh, placements, params)
        return shard_params(params, placements, self.mesh)

    def train_epoch(self, epoch: int, max_steps: Optional[int] = None):
        """One epoch from the trainer's state: ``(params, opt_state, loss)``.
        ``max_steps`` cuts it to its first steps (a custom epoch: each of
        its passes); ``None`` runs it whole."""
        generator = self.epoch_generator(epoch)
        if self._epoch_fn is not None:
            return self._epoch_fn(self.params, self.opt_state, generator, epoch, max_steps=max_steps)
        draws = self.draw_epoch(generator)
        return self.run_epoch(self.params, self.opt_state, *(a[:max_steps] for a in draws), epoch=epoch)

    def init_opt_state(self, params: Params) -> torch.optim.Optimizer:
        """A fresh optimizer over the tensors of ``params``: the model's
        ``init_opt_state(params)``, else ``make_optimizer()``'s factory
        applied to ``params``, else the configured learner's over its leaves
        (``neurec_tpu/trainer.py:133-136,486-487``)."""
        if hasattr(self.model, "init_opt_state"):
            return self.model.init_opt_state(params)
        if hasattr(self.model, "make_optimizer"):
            return self.tx(params)
        return self.tx([p for _, p in param_leaves(params)])

    def train(self) -> str:
        if self.trace_dir:
            with device_trace(self.trace_dir, self.device):
                result = self._train()
            self.logger.info("device trace written to %s" % self.trace_dir)
            return result
        return self._train()

    def _train(self) -> str:
        if self.params is None:
            self.initialize()
        model = self.model
        self.logger.info(self.evaluator.metrics_info())
        if model.data_kind == "none" or model.epochs == 0:
            result = self.evaluate()
            self.logger.info("result:\t%s" % result)
            return result
        result = ""
        start_epoch = getattr(self, "_start_epoch", 1)
        jsonl_path = None
        if getattr(self.logger, "path", None):
            jsonl_path = self.logger.path + ".metrics.jsonl"
        for epoch in range(start_epoch, model.epochs + 1):
            t0 = time.time()
            self.params, self.opt_state, loss = self.train_epoch(epoch)
            loss = float(loss)
            elapsed = time.time() - t0
            self.logger.info("[iter %d : loss : %f, time: %f]" % (epoch, loss, elapsed))
            record = {"epoch": epoch, "loss": loss, "time_s": round(elapsed, 4)}
            if epoch % model.verbose == 0:
                result = self.evaluate()
                self.logger.info("epoch %d:\t%s" % (epoch, result))
                record["metrics"] = {
                    "header": self.evaluator.metrics_info(),
                    "values": result.split("\t"),
                }
            if jsonl_path is not None:
                with open(jsonl_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            ckpt = getattr(self, "_ckpt", None)
            if ckpt is not None and epoch % self._ckpt_every == 0:
                ckpt.save(epoch, self.params, self.opt_state)
        if start_epoch > model.epochs:
            # a resumed run that had finished: still report its metrics
            self.logger.info("checkpoint already at final epoch %d; evaluating" % model.epochs)
            result = self.evaluate()
            self.logger.info("result:\t%s" % result)
        return result

    def evaluate(self) -> str:
        return self.evaluator.evaluate(self.model.predict, self.params)
