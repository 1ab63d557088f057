"""Training epochs as programs kept across epochs (``step_graph.KeptSteps``),
on the CPU.

The JAX trainer compiles its epoch once and calls it every epoch with the
key and the epoch as traced arguments. On a CUDA device the port's trainer
captures each run of steps once (the built-in epoch, each pass of a custom
epoch) and replays it at every later call, over buffers into which each
call copies its tensors. Here the CUDA side is stubbed (``FrozenGraphs``):
a capture keeps the call's step closure and runs nothing, a replay runs
that closure, the one built at the first call over the kept buffers. So a
value frozen at the first call (a Python epoch, a bias-correction table of
epoch 1's counts, a player copied once) shows up as a difference from the
eager epochs. Held here:

* each of the 32 stepped models (the 23 of the built-in epochs, the 9
  custom ones) over 3 epoch calls at ``scan_unroll`` 3: losses, params and
  optimizer state bit-equal to the eager epochs (``Trainer(graphs=False)``'s
  path, the CPU's), one graph set a run of steps, opened at epoch 1 and
  kept, and no graph captured at the second and third calls (a remainder
  graph at most where the call's count of steps moves, as GRU4Rec's does);
* APR with ``adv_epoch`` 2: epoch 1 through the kept path equals a run
  without the adversarial term, epochs 2 and 3 differ from it;
* Adam's bias corrections and SRGNN's staircase rate across calls of a
  kept run: the device tables refilled in place for t = 1 .. 3n against
  numpy's ``bias_corrections`` and ``lr_at``, and the params bit-equal to
  host-counted steps;
* a recapture when ``NEUREC_SPMM_PACK`` changes and when the params move,
  each still bit-equal to the eager epochs;
* GRU4Rec's live prefix, which changes the steps a call takes from epoch
  to epoch, on one kept program;
* a failed capture, and a host read in a step (a replay run under a guard
  that raises on one), raise and leave no program;
* IRGAN's sampler, whose CDF is summed in a fixed order: its draws follow
  the softmax and repeat for a seed;
* parity with the JAX package over 3 epochs through the kept path:
  LightGCN (small) and APR (``adv_epoch`` 2), each epoch's JAX draws
  handed in, against three calls of the JAX trainer's ``_epoch_fn``: the
  losses to rtol 1e-5 and the params to atol 1e-5.

The card's side is ``tests/test_torch_kept_epochs_cuda.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_custom_graph as custom_graph
import tests.test_torch_step_graph as step_tests
from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch import step_graph
from neurec_tpu_torch.bridge import map_params, param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig
from neurec_tpu_torch.models.general.irgan import categorical
from neurec_tpu_torch.models.sequential.srgnn import _DecayedAdam
from neurec_tpu_torch.ops import graph
from neurec_tpu_torch.step_graph import KeptSteps, Steps, at, train_step
from neurec_tpu_torch.trainer import OptaxAdam, Trainer, bias_corrections
from tests.test_torch_eval_graph import HostRead, NoHostReads
from tests.test_torch_general_zoo import CONFS as ZOO_CONFS
from tests.test_torch_general_zoo import build_both, numpy_params
from tests.test_torch_step_graph import ReplayingGraphs
from tests.test_torch_training import LIGHTGCN, SilentLogger, _both, _jax_epoch_draws, _numpy_params

torch.set_float32_matmul_precision("highest")

CPU = torch.device("cpu")
BUILT_IN = step_tests.BUILT_IN
CUSTOM = custom_graph.MODELS
EPOCHS = (1, 2, 3)
UNROLL = 3
# the JAX-parity tolerances of the epoch tests, over three epochs here
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


class FrozenGraphs(ReplayingGraphs):
    """``step_graph._CudaGraphs`` on the CPU: a capture keeps the step
    closure and runs nothing; a replay runs the kept closure, with the
    launch counts as they were."""

    made = []

    def __init__(self, device):
        super().__init__(device)
        self.released = False
        FrozenGraphs.made.append(self)

    def release(self):
        self.released = True


class GuardedGraphs(FrozenGraphs):
    """A replay under ``NoHostReads``."""

    @staticmethod
    def replay(fn):
        with NoHostReads():
            ReplayingGraphs.replay(fn)


@pytest.fixture
def frozen(monkeypatch):
    FrozenGraphs.made = []
    monkeypatch.setattr(step_graph, "_CudaGraphs", FrozenGraphs)
    return FrozenGraphs.made


def trainer_for(name, tmp_path, kept, monkeypatch):
    """The model's trainer at the small widths of the step-graph tests;
    with ``kept`` its runs of steps are kept programs
    (``step_graph.captures`` as on a card), else eager (``graphs=False``)."""
    if name == "lightgcn":  # the plan SpMM (K2's plain version on the CPU)
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    make = custom_graph.trainer_for if name in CUSTOM else step_tests.trainer_for
    trainer = make(name, tmp_path)
    trainer.graphs = kept
    if kept:
        trainer.scan_unroll = UNROLL
        monkeypatch.setattr(step_graph, "captures", lambda device, graphs=True, mesh=None: graphs)
    return trainer


def epoch_state(trainer, loss):
    return loss, trainer.params, trainer.opt_state


def snapshot(state):
    """A copy of (loss, params, optimizer) that later epochs leave alone."""
    loss, params, opt = state
    opts = opt.values() if isinstance(opt, dict) else [opt]
    return (loss.clone(), map_params(lambda v: v.detach().clone(), params),
            [copy.deepcopy(o.state_dict()["state"]) for o in opts])


def assert_snapshots_equal(a, b):
    assert torch.equal(a[0], b[0]), (float(a[0]), float(b[0]))
    for (path, x), (_, y) in zip(param_leaves(a[1]), param_leaves(b[1])):
        assert torch.equal(x, y), path
    assert len(a[2]) == len(b[2])
    for sa, sb in zip(a[2], b[2]):
        assert sa.keys() == sb.keys()
        for i in sa:
            for key, x in sa[i].items():
                assert torch.equal(x, sb[i][key]) if isinstance(x, torch.Tensor) else x == sb[i][key], key


def three_epochs(trainer, max_steps=None):
    out = []
    for epoch in EPOCHS:
        trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch, max_steps=max_steps)
        out.append(snapshot(epoch_state(trainer, loss)))
        out[-1] += ({name: (kept.calls, kept.captured) for name, kept in trainer.kept.items()},)
    return out


@pytest.mark.parametrize("name", BUILT_IN + list(CUSTOM))
def test_kept_epochs_equal_the_eager_epochs(name, tmp_path, monkeypatch, frozen):
    eager = three_epochs(trainer_for(name, tmp_path, False, monkeypatch))
    assert not frozen
    trainer = trainer_for(name, tmp_path, True, monkeypatch)
    kept = three_epochs(trainer)
    runs = 2 if name in ("cfgan", "irgan") else 1
    # one graph set a run of steps, opened at the first epoch and kept
    assert len(frozen) == runs and len(trainer.kept) == runs and not any(g.released for g in frozen)
    assert any(frozen[i].captured for i in range(runs))
    for epoch, (a, b) in enumerate(zip(eager, kept), 1):
        assert torch.isfinite(a[0]), epoch
        assert_snapshots_equal(a, b)
    # a later call captures only a remainder graph of a count of steps not
    # seen before: none where the count stays (GRU4Rec's live prefix moves)
    for later in kept[1:]:
        for name_run, (calls, captured) in later[3].items():
            assert captured <= (name in ("gru4rec", "gru4recplus")), (name_run, calls, captured)
    assert all(calls >= 3 for calls, _ in kept[-1][3].values())


def test_apr_adversarial_term_switches_on_at_adv_epoch(tmp_path, monkeypatch, frozen):
    """``adv_epoch`` 2: through the kept program, epoch 1 equals a run
    without the adversarial term (``reg_adv`` 0) and epochs 2 and 3 do not."""
    assert step_tests.CONFS["apr"]["adv_epoch"] == 2
    on = three_epochs(trainer_for("apr", tmp_path, True, monkeypatch))
    trainer = trainer_for("apr", tmp_path, True, monkeypatch)
    trainer.model.reg_adv = 0.0
    off = three_epochs(trainer)
    assert torch.equal(on[0][0], off[0][0])
    assert not torch.equal(on[1][0], off[1][0]) and not torch.equal(on[2][0], off[2][0])
    assert all(calls == 3 for kept in (on, off) for calls, _ in kept[-1][3].values())


def quadratic_steps(p, opt, targets):
    """A run of steps of ``sum((p - targets[s])^2)``."""
    def make(cursor, total, targets):
        def step(gen):
            target = at(cursor, targets)
            train_step(lambda: torch.sum(torch.square(p - target)), opt, cursor, total)
        return step
    return Steps(make, targets.shape[0], None, opt, inputs=dict(targets=targets), reads=[p])


@pytest.mark.parametrize("which", ["adam", "srgnn"])
def test_device_count_tables_are_refilled_across_calls(which, frozen):
    """Three calls of a kept run of n steps: each call's tables hold the
    rows of its own steps (t = 1 .. 3n in all), and the params equal the
    host-counted steps' bit for bit."""
    n = 5
    rng = np.random.RandomState(3)
    init = rng.randn(4, 3).astype(np.float32)
    targets = [torch.from_numpy(rng.randn(n, 4, 3).astype(np.float32)) for _ in range(3)]

    def optimizer(p):
        return OptaxAdam([p], lr=0.05) if which == "adam" else _DecayedAdam([p], lr=0.05, transition=3, rate=0.5)

    p_h = torch.from_numpy(init.copy()).requires_grad_(True)
    opt_h = optimizer(p_h)
    for call in targets:
        for s in range(n):
            opt_h.zero_grad(set_to_none=True)
            torch.sum(torch.square(p_h - call[s])).backward()
            opt_h.step()

    p = torch.from_numpy(init.copy()).requires_grad_(True)
    opt = optimizer(p)
    kept = KeptSteps(quadratic_steps(p, opt, targets[0]), CPU, UNROLL)
    held = None  # as a trainer's store keeps it: after the first call, which makes Adam's state
    for c, call in enumerate(targets):
        steps = quadratic_steps(p, opt, call)
        assert c == 0 or (step_graph.steps_holding(steps, UNROLL) == held and kept.fits(steps.n))
        kept.run(steps)
        held = held or step_graph.steps_holding(steps, UNROLL)
        t0 = c * n
        table = kept.count.tables[0][0]
        want = np.stack([bias_corrections(0.9, t0, n), bias_corrections(0.999, t0, n)], axis=1)
        assert np.array_equal(table[:n].numpy(), want), c
        if which == "srgnn":
            rates = kept.count.tables[("lr", 0)][0]
            assert np.array_equal(rates[:n].numpy(), np.float32([opt.lr_at(t0 + j) for j in range(n)])), c
        assert int(opt.state[p]["step"]) == t0 + n
    assert len(frozen) == 1 and kept.calls == 3
    assert torch.equal(p, p_h)
    assert all(torch.equal(opt.state[p][k], opt_h.state[p_h][k]) for k in ("exp_avg", "exp_avg_sq", "step"))


def test_a_changed_pack_or_moved_params_capture_anew(tmp_path, monkeypatch, frozen):
    """LightGCN (the plan SpMM): epoch 2 under ``NEUREC_SPMM_PACK=2`` (K3's
    route) and epoch 3 from params and an optimizer state copied to new
    tensors each open a new graph set and release the old one; every epoch
    equals the eager one run the same way."""
    results = []
    for kept in (False, True):
        monkeypatch.delenv("NEUREC_SPMM_PACK", raising=False)
        trainer = trainer_for("lightgcn", tmp_path, kept, monkeypatch)
        out = []
        for epoch in EPOCHS:
            if epoch == 2:
                monkeypatch.setenv("NEUREC_SPMM_PACK", "2")
            if epoch == 3:
                params, opt = step_tests.clone(trainer)
                trainer.params, trainer.opt_state = params, opt
            trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch)
            out.append(snapshot(epoch_state(trainer, loss)))
            if kept:
                assert len(frozen) == epoch and all(g.released for g in frozen[:-1]) and not frozen[-1].released
        results.append(out)
    for a, b in zip(*results):
        assert_snapshots_equal(a, b)


def test_gru4rec_live_prefix_changes_the_steps_of_one_program(tmp_path, monkeypatch, frozen):
    """GRU4Rec's schedule has a live prefix that differs by epoch: the kept
    program takes each epoch's count of steps (a remainder graph captured
    when a new count needs one) and equals the eager epochs."""
    counts = []
    real = KeptSteps.run

    def run(self, steps):
        counts.append(steps.n)
        return real(self, steps)

    eager = three_epochs(trainer_for("gru4rec", tmp_path, False, monkeypatch))
    monkeypatch.setattr(KeptSteps, "run", run)
    kept = three_epochs(trainer_for("gru4rec", tmp_path, True, monkeypatch))
    assert len(set(counts)) > 1, counts
    # one graph set: the graph of scan_unroll steps and a graph a remainder count
    assert len(frozen) == 1 and len(frozen[0].captured) <= UNROLL
    for a, b in zip(eager, kept):
        assert_snapshots_equal(a, b)


@pytest.mark.parametrize("items", [1, 511, 512, 1300])
def test_irgan_categorical_draws_follow_the_softmax(items):
    """IRGAN's sampler (a CDF summed in a fixed order, so that a kept G
    pass can equal the eager one on a card): each row's draws follow its
    softmax within 5 standard errors, an item of no mass is never drawn,
    and a seed gives the same draws."""
    g = torch.Generator().manual_seed(items)
    logits = torch.randn(3, items, generator=g) * 2
    logits[1, 1::3] = -torch.inf
    n = 100000
    draws = categorical(torch.Generator().manual_seed(1), logits, n)
    assert draws.shape == (3, n) and draws.dtype == torch.int64
    assert torch.equal(draws, categorical(torch.Generator().manual_seed(1), logits, n))
    p = torch.softmax(logits, dim=-1).double()
    for r in range(3):
        freq = torch.bincount(draws[r], minlength=items).double() / n
        assert torch.all((freq - p[r]).abs() <= 5 * torch.sqrt(p[r] * (1 - p[r]) / n) + 1e-12), r
    assert not torch.isin(draws[1], torch.arange(1, items, 3)).any()


def test_a_failed_capture_or_host_read_raises_and_keeps_nothing(tmp_path, monkeypatch, frozen):
    class Failing(FrozenGraphs):
        def capture(self, fn, generators):
            raise RuntimeError("capture failed")

    trainer = trainer_for("mf", tmp_path, True, monkeypatch)
    monkeypatch.setattr(step_graph, "_CudaGraphs", Failing)
    with pytest.raises(RuntimeError, match="capture failed"):
        trainer.train_epoch(1)
    assert not trainer.kept and frozen[-1].released

    monkeypatch.setattr(step_graph, "_CudaGraphs", GuardedGraphs)
    trainer = trainer_for("sbpr", tmp_path, True, monkeypatch)
    real = trainer.model.sbpr_loss

    def syncing(*args):
        loss = real(*args)
        float(loss.detach())  # a host read
        return loss

    trainer.model.sbpr_loss = syncing
    with pytest.raises(HostRead):
        trainer.train_epoch(1)
    assert not trainer.kept and frozen[-1].released


def _kept_trainer(model, ds, conf, monkeypatch):
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    trainer.scan_unroll = UNROLL
    monkeypatch.setattr(step_graph, "captures", lambda device, graphs=True, mesh=None: graphs)
    return trainer


@pytest.mark.parametrize("name", ["lightgcn", "apr"])
def test_kept_epochs_with_injected_jax_draws_match_jax(name, monkeypatch, frozen):
    """Three epochs through the kept program, each fed that JAX epoch's
    draws (``_jax_epoch_draws``), against three calls of the JAX trainer's
    jitted epoch: each epoch's loss to rtol LOSS_RTOL and the params after
    it to atol PARAM_ATOL. APR at ``adv_epoch`` 2 switches its adversarial
    term on at the second epoch in both."""
    if name == "lightgcn":
        conf = LIGHTGCN
        ds_j, ds, model_j, model = _both(conf, seed=4)
        params_np = _numpy_params(model, 5)
    else:
        conf = dict(ZOO_CONFS["apr-grad"], adv_epoch=2)
        ds_j, ds, model_j, model = build_both(conf, seed=4)
        params_np = numpy_params(model_j, 5, scale=0.3)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = _kept_trainer(model, ds, conf, monkeypatch)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_j = jt.tx.init(params_j)
    params = map_params(lambda t: t.requires_grad_(True), params_from_numpy(params_np, "cpu"))
    opt = trainer.init_opt_state(params)
    start = dict(param_leaves(params_np))
    for epoch in EPOCHS:
        ekey, inst, w, negs = _jax_epoch_draws(jt, epoch=epoch)
        params_j, opt_j, loss_j = jt._epoch_fn(params_j, opt_j, ekey, jnp.int32(epoch))
        params, opt, loss = trainer.run_epoch(params, opt, torch.from_numpy(inst), torch.from_numpy(w),
                                              torch.from_numpy(negs), epoch=epoch)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL, err_msg=str(epoch))
        want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
        for path, p in param_leaves(params_to_numpy(params)):
            np.testing.assert_allclose(p, want[path], atol=PARAM_ATOL, err_msg="%s %s" % (epoch, path))
            assert not np.allclose(p, start[path])
    assert len(frozen) == 1 and trainer.kept["epoch"].calls == 3 and trainer.kept["epoch"].captured == 0
