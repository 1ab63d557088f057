"""The custom epochs' steps (SBPR, Caser, SASRec, SRGNN, JCA, CFGAN, IRGAN,
GRU4Rec, GRU4RecPlus) as step functions that a CUDA graph can hold, on the
CPU.

On a CUDA device each custom epoch's runs of steps (``step_graph.Steps``)
are replays of CUDA graphs of ``scan_unroll`` steps, as the JAX package runs
each custom epoch as one jitted ``lax.scan``; on the CPU the same step
functions run eagerly. Held here, at small widths:

* a run's step closure built once and driven through ``run_steps`` gives
  the bits of closures rebuilt at each cursor (each a fresh function over
  the cursor ``[s]``, its generator seeded with the step's seed), loss
  total, params and optimizer state: the closure holds no Python value that
  changes from step to step;
* ``max_steps`` cuts a run to the whole run's first steps, bit for bit;
* through the runner's captured path with the CUDA side stubbed (a warm-up
  step, graphs of ``scan_unroll`` 1 and 3 steps and a remainder, each
  graph position on a generator of its own), two epochs equal the eager
  ones bit for bit, one graph set a run of steps, kept across the epochs;
* through that captured path, the epoch with the JAX package's draws
  injected through the model's draw methods still matches the JAX
  package's ``lax.scan`` epoch, by the existing parity tests run under it,
  at the tolerances they state: SBPR's loss rtol 2e-5 and params atol
  2e-5 (``test_torch_social.py``), SASRec's, Caser's, SRGNN's and the four
  GRU4Rec variants' loss rtol 2e-5 and params atol 2e-5
  (``test_torch_seq_epochs.py``), JCA's, CFGAN's and IRGAN's loss rtol
  1e-5 and params atol 2e-5 (``test_torch_custom_epochs.py``);
* GRU4Rec's schedules: the steps without a valid entry are a suffix, so a
  run takes the live prefix (``live_prefix``), which rejects a gap;
* IRGAN's in-place ``_sgd_step`` equals the functional ``p - lr * g`` it
  replaced, bit for bit, over successive steps;
* SRGNN's decayed Adam in a counted block (the rate from a device table)
  equals its host steps across a staircase boundary, bit for bit.

The card's side (captured == eager on a CUDA device, a host sync raising)
is ``tests/test_torch_custom_graph_cuda.py``.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import tests.test_torch_custom_epochs as custom_epochs
import tests.test_torch_seq_epochs as seq_epochs
import tests.test_torch_social as social
from neurec_tpu_torch import step_graph
from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.base import Recommender
from neurec_tpu_torch.models.sequential.gru4rec import live_prefix
from neurec_tpu_torch.models.sequential.srgnn import _DecayedAdam
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_general_rest import CONFS as GENERAL_CONFS
from tests.test_torch_seq_models import CONFS as SEQ_CONFS
from tests.test_torch_step_graph import ReplayingGraphs
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

MODELS = ("sbpr", "caser", "sasrec", "srgnn", "jca", "cfgan", "irgan", "gru4rec", "gru4recplus")
# a model's runs of steps: the epoch's, or each pass's
RUNS = ("sbpr", "caser", "sasrec", "srgnn", "jca", "cfgan-d", "cfgan-g", "irgan-d", "irgan-g", "gru4rec",
        "gru4recplus")
CPU = torch.device("cpu")


def trainer_for(name, tmp_path, **over):
    """The port's trainer of ``name`` at small widths, on the CPU."""
    if name == "sbpr":
        root = str(tmp_path / "social")
        social.write_files(root)
        conf = social.configs(root, "SBPR", social.SBPR_ARGS)[1]
        ds = Dataset(conf)
    elif name in SEQ_CONFS:
        # SASRec at 4 rows a step: 8 steps, a graph of 3 and a remainder
        conf = DictConfig(dict(SEQ_CONFS[name], **({"batch_size": 4} if name == "sasrec" else {})))
        ds = random_dataset(num_users=30, num_items=40, min_per_user=3, max_per_user=14, seed=1)
    else:
        conf = DictConfig(GENERAL_CONFS[name])
        ds = random_dataset(num_users=40, num_items=60, seed=1)
    model = get_model(conf["recommender"])(ds, conf, device="cpu")
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), seed=7, device="cpu", **over)
    trainer.initialize()
    return trainer


def fresh_state(trainer):
    """A copy of the trainer's params and a fresh optimizer over it."""
    params = map_params(lambda v: v.detach().clone().requires_grad_(v.is_floating_point()), trainer.params)
    return params, trainer.init_opt_state(params)


def plan(run, trainer, params, opt, generator, max_steps=None):
    """``(steps, state)``: the run's ``step_graph.Steps`` and the tree its
    steps update (the params, or IRGAN's player)."""
    model = trainer.model
    if run in ("sbpr", "caser", "sasrec", "srgnn"):
        return model.epoch_steps(params, opt, generator, max_steps, trainer), params
    if run == "jca":
        return model.grid_steps(params, opt, model.draw_epoch(generator), max_steps, trainer), params
    if run in ("cfgan-d", "cfgan-g"):
        side, batch = ("dis", model.batchSize_D) if run == "cfgan-d" else ("gen", model.batchSize_G)
        return model.sub_epoch_steps(params, opt[run[-1]], generator, run[-1] + "_loss", side, batch, max_steps,
                                     trainer), params
    if run == "irgan-d":
        return model.d_steps(params, generator, max_steps, trainer)
    if run == "irgan-g":
        return model.g_steps(params, generator, max_steps)
    return model.schedule_steps(params, opt, *model.schedule(generator), generator, max_steps, trainer), params


def counted(steps):
    count = getattr(steps.opt, "count_steps", None)
    return count(steps.n) if count is not None else contextlib.nullcontext()


def opt_tensors(opt):
    """Every tensor of an optimizer's state (of each optimizer of a dict)."""
    opts = opt.values() if isinstance(opt, dict) else [opt]
    return [v for o in opts for p in o.state for v in o.state[p].values() if isinstance(v, torch.Tensor)]


def assert_same(a, b):
    """Two (loss, state tree, optimizer) triples, bit for bit."""
    assert torch.equal(a[0], b[0]), (float(a[0]), float(b[0]))
    for (path, x), (_, y) in zip(param_leaves(a[1]), param_leaves(b[1])):
        assert torch.equal(x, y), path
    xs, ys = opt_tensors(a[2]), opt_tensors(b[2])
    assert len(xs) == len(ys)
    assert all(torch.equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.parametrize("run", RUNS)
def test_a_step_closure_built_once_equals_closures_rebuilt_at_each_cursor(run, tmp_path):
    name = run.split("-")[0]
    trainer = trainer_for(name, tmp_path)
    out = []
    for rebuilt in (False, True):
        params, opt = fresh_state(trainer)
        steps, state = plan(run, trainer, params, opt, torch.Generator().manual_seed(3))
        assert steps.n >= 3, steps.n
        total = torch.zeros(())
        with counted(steps):
            if not rebuilt:
                cursor = torch.zeros(1, dtype=torch.int64)
                step_graph.run_steps(steps.make(cursor, total, **steps.inputs), steps.n, steps.seeds, CPU)
                assert int(cursor) == steps.n
            else:
                gen = torch.Generator()
                for s in range(steps.n):
                    step = steps.make(torch.tensor([s]), total, **steps.inputs)
                    step(None if steps.seeds is None else gen.manual_seed(int(steps.seeds[s])))
        out.append((total, state, opt))
    assert float(out[0][0]) != 0.0
    assert_same(*out)


@pytest.mark.parametrize("run", RUNS)
def test_max_steps_cuts_a_run_to_its_first_steps(run, tmp_path):
    name = run.split("-")[0]
    trainer = trainer_for(name, tmp_path)
    k = 2
    out = []
    for cut in (True, False):
        params, opt = fresh_state(trainer)
        steps, state = plan(run, trainer, params, opt, torch.Generator().manual_seed(5), k if cut else None)
        if cut:
            assert steps.n == k
        else:
            assert steps.n > k
            steps = steps._replace(n=k, seeds=None if steps.seeds is None else steps.seeds[:k])
        out.append((step_graph.take_steps(steps, CPU), state, opt))
    assert_same(*out)


def _stub_graphs(monkeypatch):
    """``step_graph._CudaGraphs`` replaced by ``ReplayingGraphs``; returns
    the list of the graph sets a run opened."""
    opened = []

    def graphs(device):
        opened.append(ReplayingGraphs(device))
        return opened[-1]

    monkeypatch.setattr(step_graph, "_CudaGraphs", graphs)
    return opened


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("unroll", [1, 3])
def test_captured_epochs_equal_the_eager_ones(name, unroll, tmp_path, monkeypatch):
    """Two epochs through ``train_epoch``: eagerly, and through the
    runner's captured path with the CUDA side stubbed (the trainer's
    ``_captures`` true), one graph set per run of steps (the epoch's, or
    each kind of pass: CFGAN's D and G sub-epochs, IRGAN's D and G passes),
    captured at epoch 1 and kept: epoch 2 replays it."""
    opened = _stub_graphs(monkeypatch)
    results = []
    for captured in (False, True):
        trainer = trainer_for(name, tmp_path)
        trainer.scan_unroll = unroll
        if captured:
            monkeypatch.setattr(trainer, "_captures", lambda: True)
        losses = []
        for epoch in (1, 2):
            trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch)
            losses.append(loss)
        results.append((torch.stack(losses), trainer.params, trainer.opt_state))
        if not captured:
            assert not opened
    runs = 2 if name in ("cfgan", "irgan") else 1
    assert len(opened) == runs and len(trainer.kept) == runs
    # the generators each graph holds, one a position (none where a step draws nothing)
    widths = [g.captured for g in opened if any(g.captured)]
    assert all(max(w) <= unroll for w in widths) and (name == "srgnn" or any(w[0] == unroll for w in widths)), widths
    assert torch.isfinite(results[0][0]).all()
    assert_same(*results)


def _captured_take_steps(self, trainer, steps):
    """A run of steps through a ``KeptSteps`` of ``scan_unroll`` 3, released
    at its end."""
    kept = step_graph.KeptSteps(steps, self.device, 3)
    try:
        total = kept.run(steps)
    finally:
        kept.release()
    return total if trainer is None else trainer.dp_loss_total(total, steps.split)


JAX_PARITY = {
    "sbpr": lambda tmp_path: social.test_sbpr_epoch_with_injected_jax_draws_matches_jax(tmp_path),
    "sasrec": lambda tmp_path: seq_epochs.test_sasrec_epoch_with_injected_jax_draws_matches_jax(),
    "caser": lambda tmp_path: seq_epochs.test_caser_epoch_with_injected_jax_draws_matches_jax(),
    "srgnn": lambda tmp_path: seq_epochs.test_srgnn_epoch_with_injected_jax_draws_matches_jax(),
    "jca": lambda tmp_path: custom_epochs.test_jca_epoch_with_injected_jax_draws_matches_jax(),
    "cfgan": lambda tmp_path: custom_epochs.test_cfgan_epoch_with_injected_jax_draws_matches_jax("cfgan"),
    "cfgan-item": lambda tmp_path: custom_epochs.test_cfgan_epoch_with_injected_jax_draws_matches_jax("cfgan-item"),
    "irgan": lambda tmp_path: custom_epochs.test_irgan_epoch_with_injected_jax_draws_matches_jax(),
}
for _name in ("gru4rec", "gru4rec-bpr", "gru4recplus", "gru4recplus-top1"):
    JAX_PARITY[_name] = lambda tmp_path, _n=_name: seq_epochs.test_gru4rec_epoch_with_injected_jax_draws_matches_jax(_n)


@pytest.mark.parametrize("name", sorted(JAX_PARITY))
def test_captured_epoch_with_injected_jax_draws_matches_jax(name, tmp_path, monkeypatch):
    """The existing JAX-parity test of the epoch, its draws injected through
    the model's draw methods, with every run of steps taken through the
    captured path (CUDA side stubbed, ``scan_unroll`` 3): the JAX epoch's
    loss and params at the tolerance that test states (module docstring)."""
    opened = _stub_graphs(monkeypatch)
    monkeypatch.setattr(Recommender, "take_steps", _captured_take_steps)
    JAX_PARITY[name](tmp_path)
    assert opened and any(g.captured for g in opened)


@pytest.mark.parametrize("batch", [1, 4, 7, 32])
def test_gru4rec_pad_steps_are_a_suffix(batch):
    """Every stream runs from step 0 without a gap, so a schedule's steps
    without a valid entry come after its live ones; ``live_prefix`` counts
    the live steps and rejects a schedule with a gap."""
    _, _, _, model = seq_epochs.build_both(dict(SEQ_CONFS["gru4rec"], batch_size=batch), seed=2)
    rng = np.random.RandomState(7)
    for _ in range(3):
        ins, outs, resets, valids = model._build_schedule(rng.permutation(model.num_users), batch)
        live = valids.any(axis=1)
        assert live.all()  # the built schedule: no pad step before its end
        padded = np.pad(valids, ((0, 5), (0, 0)))
        assert live_prefix(padded) == live_prefix(valids) == int(live.sum()) == len(live)
    gap = padded.copy()
    gap[1] = False
    with pytest.raises(ValueError):
        live_prefix(gap)
    assert live_prefix(np.zeros((3, batch), bool)) == 0


def test_irgan_in_place_sgd_step_equals_the_functional_one(tmp_path):
    """``_sgd_step`` updates the leaves in place with the arithmetic of the
    fresh leaves ``p - lr * grad`` it replaced, over successive D steps."""
    trainer = trainer_for("irgan", tmp_path)
    model = trainer.model
    rng = np.random.RandomState(0)
    in_place = model._player(trainer.params["dis"])
    functional = model._player(trainer.params["dis"])
    leaves = {k: id(v) for k, v in in_place.items()}
    for _ in range(5):
        u = torch.from_numpy(rng.randint(0, model.num_users, 16)).long()
        i = torch.from_numpy(rng.randint(0, model.num_items, 16)).long()
        lbl = torch.from_numpy((rng.rand(16) < 0.5).astype(np.float32))
        w = torch.from_numpy((rng.rand(16) < 0.8).astype(np.float32))
        model._sgd_step(in_place, model._d_loss(in_place, u, i, lbl, w))
        loss = model._d_loss(functional, u, i, lbl, w)
        grads = torch.autograd.grad(loss, list(functional.values()))
        functional = {k: (p - model.lr * g).detach().requires_grad_(True)
                      for (k, p), g in zip(functional.items(), grads)}
        for k in functional:
            assert torch.equal(in_place[k], functional[k]), k
    assert {k: id(v) for k, v in in_place.items()} == leaves
    assert all(v.requires_grad for v in in_place.values())
    assert not torch.equal(in_place["user_emb"], trainer.params["dis"]["user_emb"])


def test_srgnn_decayed_adam_counted_on_the_device_equals_its_host_steps():
    """A counted block crossing the staircase (transition 3, from a count
    of 2) takes each step's rate from the device table: the host steps'
    bits."""
    rng = np.random.RandomState(1)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(9)]
    init = rng.randn(4, 3).astype(np.float32)

    def run(counted_block):
        p = torch.from_numpy(init.copy()).requires_grad_(True)
        opt = _DecayedAdam([p], lr=0.05, transition=3, rate=0.5)
        for block in (grads[:2], grads[2:]):
            with opt.count_steps(len(block)) if counted_block else contextlib.nullcontext():
                for g in block:
                    p.grad = torch.from_numpy(g)
                    opt.step()
        return p, opt

    (p_h, opt_h), (p_d, opt_d) = run(False), run(True)
    assert torch.equal(p_h, p_d)
    assert int(opt_d.state[p_d]["step"]) == 9
    assert opt_h.param_groups[0]["lr"] == pytest.approx(0.05 * 0.5 ** 2)
    state_h, state_d = copy.deepcopy(opt_h.state[p_h]), copy.deepcopy(opt_d.state[p_d])
    assert all(torch.equal(state_h[k], state_d[k]) for k in state_h)
