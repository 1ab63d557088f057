"""The built-in epochs' step function (``Trainer._step``) and its runner
(``step_graph.run_steps``), on the CPU.

On a CUDA device ``run_epoch`` replays the step as CUDA graphs of
``scan_unroll`` steps; on the CPU it calls the same step function eagerly.
Held here:

* for each of the 23 built-in-epoch models (the four sampled kinds and
  ``dense_row``), 2 epochs through ``run_epoch`` against a plain per-step
  loop written here (the loop ``run_epoch`` was before the step function:
  Python step indices, Adam's bias corrections from the host count,
  ``batch["step"]`` a Python int), bit for bit: losses, params and the
  optimizer state; the default generator is not drawn from;
* the runner's captured path with a stub in place of the CUDA side: at
  ``scan_unroll`` 1, 3 and 4 over 7 steps (a remainder graph) the epochs
  equal the eager one bit for bit; the launch counts a capture takes are
  added once a replay, and each replay's generators carry its steps' seeds;
* ``OptaxAdam``'s device bias corrections against numpy's f32 ``1 - b^t``
  for t = 1 .. 10^5, and the host step count after a counted block through
  ``bridge.adam_state_to_numpy``;
* MultiVAE's anneal on the device against the Python float;
* APR's ``adv_epoch`` switch, fixed for a run of steps;
* the registry's built-in-epoch models are the 23 held here.

The JAX-parity tests of the epochs (``test_torch_general_epochs.py``,
``test_torch_dense_row_epoch.py``, ``test_torch_seq_data.py``,
``test_torch_training.py``, ...) run through the same ``run_epoch``.
"""

import copy

import numpy as np
import pytest
import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.bridge import adam_state_to_numpy, map_params, param_leaves
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model, registered_models
from neurec_tpu_torch.ops import _build, graph
from neurec_tpu_torch.trainer import OptaxAdam, Trainer, bias_corrections
from tests.test_torch_social import DIFFNET_ARGS, configs, write_files
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 16}
# each model at small widths, with its draws switched on where it has any
CONFS = {
    "mf": dict(recommender="MF", embedding_size=8, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "lightgcn": dict(recommender="LightGCN", embed_size=8, n_layers=3, reg=0.01, adj_type="pre"),
    "ngcf": dict(recommender="NGCF", embedding_size=8, layer_size=[8, 6, 4], reg=0.01, adj_type="norm",
                 mess_dropout_ratio=0.1, node_dropout_flag=True, node_dropout_ratio=0.1),
    "fism": dict(recommender="FISM", embedding_size=8, alpha=0.5, is_pairwise=False, loss_function="square",
                 num_neg=2, **{"lambda": 0.01, "gamma": 0.02}),
    "nais": dict(recommender="NAIS", embedding_size=8, weight_size=4, regs=[0.01, 0.02, 0.03], alpha=0.3,
                 beta=0.5, algorithm=0, activation=0, is_pairwise=False, loss_function="cross_entropy",
                 num_neg=2),
    "deepicf": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=True,
                    regs=[0.01, 0.02, 0.03], alpha=0.3, beta=0.5, num_neg=2),
    "neumf": dict(recommender="NeuMF", embedding_size=4, layers=[16, 8, 4], reg_mf=0.01, reg_mlp=0.02,
                  is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "mlp": dict(recommender="MLP", layers=[16, 8, 4], reg_mlp=0.01, is_pairwise=True, loss_function="bpr"),
    "apr": dict(recommender="APR", embedding_size=8, reg=0.01, reg_adv=1.0, adv="random", eps=0.5, adv_epoch=2),
    "convncf": dict(recommender="ConvNCF", embedding_size=8, net_channel=[4, 4, 4], regs=[0.01, 0.02, 0.03],
                    lr_embed=0.05, lr_net=0.02, keep=0.8),
    "dmf": dict(recommender="DMF", layers=[16, 8], loss_function="cross_entropy", num_negatives=2),
    "spectralcf": dict(recommender="SpectralCF", embedding_size=8, num_layers=2, reg=0.01),
    "fpmc": dict(recommender="FPMC", embedding_size=8, reg_mf=0.01, is_pairwise=False, num_neg=2,
                 loss_function="cross_entropy", init_method="uniform"),
    "fpmcplus": dict(recommender="FPMCplus", embedding_size=8, weight_size=4, high_order=3, reg_mf=0.01,
                     reg_w=0.01, is_pairwise=True, loss_function="BPR"),
    "fossil": dict(recommender="Fossil", embedding_size=8, alpha=0.5, regs=[0.01, 0.02, 0.03], high_order=2,
                   is_pairwise=False, num_neg=2, loss_function="cross_entropy"),
    "hrm": dict(recommender="HRM", embedding_size=8, reg_mf=0.01, high_order=2, pre_agg="max", session_agg="max",
                num_neg=2),
    "npe": dict(recommender="NPE", embedding_size=8, reg=0.01, high_order=3, num_neg=2),
    "transrec": dict(recommender="TransRec", embedding_size=8, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "multidae": dict(recommender="MultiDAE", p_dim=[8, 16], reg=0.01, keep_prob=0.8),
    "multivae": dict(recommender="MultiVAE", p_dim=[8, 16], reg=0.01, total_anneal_steps=5, anneal_cap=0.6),
    "dae": dict(recommender="DAE", hidden_neuron=10, corruption_level=0.3, reg=0.01),
    "cdae": dict(recommender="CDAE", hidden_dim=8, num_neg=2, dropout=0.5, reg=0.01),
}
for _c in CONFS.values():
    _c.update(EVAL, batch_size=48, learner="adam", learning_rate=0.01)
CONFS["lightgcn"].update(learner="adagrad", learning_rate=0.05)
CONFS["mlp"].update(learner="momentum", learning_rate=0.05)
CONFS["fossil"].update(learner="gd", learning_rate=0.05)
CONFS["npe"].update(learner="rmsprop")
for _name in ("multidae", "multivae", "dae", "cdae"):
    CONFS[_name]["batch_size"] = 12
BUILT_IN = sorted(CONFS) + ["diffnet"]
SEQUENTIAL = ("fpmc", "fpmcplus", "fossil", "hrm", "npe", "transrec")


def build(name, tmp_path=None, size=(40, 60)):
    """The port's model ``name`` and its dataset, on the CPU."""
    if name == "diffnet":
        root = str(tmp_path / "social")
        write_files(root)
        conf = configs(root, "DiffNet", DIFFNET_ARGS + ["--batch_size=48"])[1]
        ds = Dataset(conf)
        return get_model("DiffNet")(ds, conf, device="cpu"), ds, conf
    conf = DictConfig(CONFS[name])
    kw = dict(min_per_user=3, max_per_user=14) if name in SEQUENTIAL else {}
    ds = random_dataset(num_users=size[0], num_items=size[1], seed=1, **kw)
    return get_model(conf["recommender"])(ds, conf, device="cpu"), ds, conf


def clone(trainer):
    """A copy of the trainer's params and a fresh optimizer over it with
    the trainer's optimizer state."""
    params = map_params(lambda v: v.detach().clone().requires_grad_(v.is_floating_point()), trainer.params)
    opt = trainer.init_opt_state(params)
    opt.load_state_dict(copy.deepcopy(trainer.opt_state.state_dict()))
    return params, opt


def plain_epoch(trainer, params, opt, draws, epoch):
    """The built-in epoch as a plain loop: step ``s`` of the draws' rows by
    a Python index, a generator seeded with ``seeds[s]``, ``batch["step"]``
    a Python int, and the optimizer's host-counted step."""
    inst, w, negs, seeds = draws
    total = torch.zeros(())
    gen = torch.Generator()
    for s in range(inst.shape[0]):
        batch = trainer._batch(inst[s], negs[s])
        batch["epoch"] = epoch
        if trainer._dense_row:
            batch["step"] = (epoch - 1) * trainer.steps + s
        batch["generator"] = gen.manual_seed(int(seeds[s]))
        opt.zero_grad(set_to_none=True)
        loss = trainer.model.loss(params, batch, w[s])
        loss.backward()
        opt.step()
        total += loss.detach()
    return total / inst.shape[0]


def assert_same_state(params_a, opt_a, params_b, opt_b):
    for (path, a), (_, b) in zip(param_leaves(params_a), param_leaves(params_b)):
        assert torch.equal(a, b), path
    for pa, pb in zip((p for g in opt_a.param_groups for p in g["params"]),
                      (p for g in opt_b.param_groups for p in g["params"])):
        sa, sb = opt_a.state.get(pa, {}), opt_b.state.get(pb, {})
        assert sorted(sa) == sorted(sb)
        for key in sa:
            if isinstance(sa[key], torch.Tensor):
                assert torch.equal(sa[key], sb[key]), key
            else:
                assert sa[key] == sb[key], key


def trainer_for(name, tmp_path, **over):
    model, ds, conf = build(name, tmp_path)
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), seed=7, device="cpu", **over)
    trainer.initialize()
    return trainer


@pytest.mark.parametrize("name", BUILT_IN)
def test_epochs_equal_the_plain_loop(name, tmp_path, monkeypatch):
    if name == "lightgcn":  # the plan SpMM (K2's plain version on the CPU) in place of the dense matmul
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    trainer = trainer_for(name, tmp_path)
    assert trainer.model.data_kind in ("pairwise", "pointwise", "time_pairwise", "time_pointwise", "dense_row")
    assert 2 <= trainer.steps <= 24
    if name == "lightgcn":
        assert trainer.model.adj.plan is not None
    params_p, opt_p = clone(trainer)
    default = torch.default_generator.get_state()
    for epoch in (1, 2):
        draws = trainer.draw_epoch(trainer.epoch_generator(epoch))
        trainer.params, trainer.opt_state, loss = trainer.run_epoch(trainer.params, trainer.opt_state, *draws,
                                                                    epoch=epoch)
        loss_p = plain_epoch(trainer, params_p, opt_p, draws, epoch)
        assert torch.isfinite(loss) and torch.equal(loss, loss_p), (epoch, float(loss), float(loss_p))
        assert_same_state(trainer.params, trainer.opt_state, params_p, opt_p)
    assert torch.equal(torch.default_generator.get_state(), default)
    if isinstance(trainer.opt_state, OptaxAdam):
        assert {int(s["step"]) for s in trainer.opt_state.state.values() if s} == {2 * trainer.steps}


class ReplayingGraphs:
    """``step_graph._CudaGraphs`` on the CPU: a capture keeps the steps and
    runs nothing; a replay runs them, with the launch counts as they were
    (a replay calls no wrapper)."""

    def __init__(self, device):
        self.captured = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def warm_up(self, fn):
        fn()

    def capture(self, fn, generators):
        self.captured.append(len(generators))
        return fn

    @staticmethod
    def replay(fn):
        before = dict(_build.LAUNCHES)
        fn()
        _build.LAUNCHES.update(before)

    def release(self):
        pass

    def reserved(self, empty=False):
        return 0


@pytest.mark.parametrize("name", ["ngcf", "lightgcn", "convncf", "multivae"])
def test_scan_unroll_replays_equal_the_eager_epoch(name, tmp_path, monkeypatch):
    """Through the runner's captured path (the CUDA side stubbed): a warm-up
    step, graphs of ``scan_unroll`` steps and a remainder graph over 7 steps,
    each graph's positions on generators of their own."""
    if name == "lightgcn":
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    CONF = dict(CONFS[name], batch_size=6 if name == "multivae" else 8)
    monkeypatch.setitem(CONFS, name, CONF)
    results = {}
    for unroll in (None, 1, 3, 4):
        trainer = trainer_for(name, tmp_path)
        trainer.scan_unroll = unroll or 1
        draws = trainer.draw_epoch(trainer.epoch_generator(2))
        draws = tuple(a[:7] for a in draws)
        assert draws[0].shape[0] == 7
        stub = []
        if unroll is not None:
            def graphs(device, stub=stub):
                stub.append(ReplayingGraphs(device))
                return stub[-1]
            monkeypatch.setattr(step_graph, "_CudaGraphs", graphs)
            monkeypatch.setattr(trainer, "_captures", lambda: True)
        else:
            monkeypatch.setattr(step_graph, "_CudaGraphs", None)
        params, opt, loss = trainer.run_epoch(trainer.params, trainer.opt_state, *draws, epoch=2)
        if unroll is not None:
            k = min(unroll, 6)
            # the graph of k, the remainder of the 6 steps past the warm-up
            # and the one a later call of 7 steps would take
            assert stub[0].captured == [k] + [r for r in dict.fromkeys((6 % k, 7 % k)) if r]
        results[unroll] = (loss, params, opt)
    loss0, params0, opt0 = results[None]
    for unroll in (1, 3, 4):
        loss, params, opt = results[unroll]
        assert torch.equal(loss, loss0), unroll
        assert_same_state(params, opt, params0, opt0)


def test_replays_add_the_captured_launches_and_seed_each_position(monkeypatch):
    """A capture runs the steps' host code once (a wrapper counts there), a
    replay none: the runner puts the counts back after a capture and adds
    them once a replay; before each replay, position j's generator carries
    the seed of the replay's step j."""
    events = []

    class CountingGraphs(ReplayingGraphs):
        def capture(self, fn, generators):
            fn()
            return len(generators), list(generators)

        @staticmethod
        def replay(handle):
            count, gens = handle
            events.append(("replay", [g.initial_seed() for g in gens]))

    def step(generator):
        _build.LAUNCHES["plan_spmm"] += 3
        _build.LAUNCHES["plan_spmm_t"] += 3
        events.append(("step", generator.initial_seed()))

    monkeypatch.setattr(step_graph, "_CudaGraphs", CountingGraphs)
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    _build.reset_launches()
    seeds = torch.arange(100, 107, dtype=torch.int64)
    graphs = step_graph._StepGraphs(step, torch.device("cpu"), 4, draws=True)
    graphs.run(7, seeds)
    graphs.release()
    assert (_build.LAUNCHES["plan_spmm"], _build.LAUNCHES["plan_spmm_t"]) == (21, 21)
    replays = [e[1] for e in events if e[0] == "replay"]
    assert replays == [[101, 102, 103, 104], [105, 106]]
    assert events[0] == ("step", 100)  # the warm-up, eager: the epoch's step 0
    # eagerly: one generator, seeded step by step, the counts as the wrappers made them
    events.clear()
    _build.reset_launches()
    step_graph.run_steps(step, 7, seeds, torch.device("cpu"))
    assert [e[1] for e in events] == list(range(100, 107))
    assert _build.LAUNCHES["plan_spmm"] == 21


def test_captured_launches_restores_and_reports():
    saved = dict(_build.LAUNCHES)
    try:
        _build.LAUNCHES["masked_scores"] = 5
        with _build.captured_launches() as delta:
            _build.LAUNCHES["masked_scores"] += 2
            _build.LAUNCHES["plan_spmm"] += 3
        assert delta == {"masked_scores": 2, "plan_spmm": 3}
        assert _build.LAUNCHES["masked_scores"] == 5
        _build.add_launches(delta)
        _build.add_launches(delta)
        assert _build.LAUNCHES["masked_scores"] == 9 and _build.LAUNCHES["plan_spmm"] == saved["plan_spmm"] + 6
    finally:
        _build.LAUNCHES.update(saved)


def test_adam_device_bias_corrections_equal_numpy_scalars():
    n = 100_000
    for b in (0.9, 0.999):
        want = np.array([np.float32(1.0) - np.float32(b) ** np.float32(t) for t in range(1, n + 1)], np.float32)
        assert np.array_equal(bias_corrections(b, 0, n), want)
        assert np.array_equal(bias_corrections(b, 4321, 17), want[4321:4338])
        table = torch.from_numpy(bias_corrections(b, 0, n))
        cursor = torch.zeros(1, dtype=torch.int64)
        for t in (1, 2, 3, 1000, n):
            cursor.fill_(t - 1)
            assert table.index_select(0, cursor)[0].item() == float(want[t - 1])


def test_adam_counted_block_equals_host_steps_and_round_trips():
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (4,)}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(9)]
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def run(counted):
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
        opt = OptaxAdam(list(params.values()), lr=0.05)
        for t0, block in ((0, grads[:2]), (2, grads[2:9])):  # the second block starts from a count of 2
            with opt.count_steps(len(block)) if counted else torch.no_grad():
                for g in block:
                    for k, p in params.items():
                        p.grad = torch.from_numpy(g[k])
                    opt.step()
                    if counted:  # the host counts move at the block's end
                        assert {int(s["step"]) for s in opt.state.values()} == {t0}
        return params, opt

    params_h, opt_h = run(False)
    params_d, opt_d = run(True)
    for k in shapes:
        assert torch.equal(params_h[k], params_d[k]), k
    count, mu, nu = adam_state_to_numpy(opt_d, params_d)
    count_h, mu_h, nu_h = adam_state_to_numpy(opt_h, params_h)
    assert count == count_h == 9 and count.dtype == np.int32
    for k in shapes:
        assert np.array_equal(mu[k], mu_h[k]) and np.array_equal(nu[k], nu_h[k])
    assert all(s["step"].device.type == "cpu" and s["step"].dtype == torch.float32 for s in opt_d.state.values())


def test_multivae_device_anneal_equals_the_python_float():
    """``min(cap, step / total)`` on the device in f64, cast to f32, times
    an f32 tensor gives the bits of the Python float times it, below, at and
    past the cap; the loss takes a device step as it takes an int."""
    model, ds, _ = build("multivae")
    total, cap = model.total_anneal_steps, model.anneal_cap
    kl = torch.from_numpy(np.random.RandomState(0).uniform(0.1, 50.0, 64).astype(np.float32))
    for step in range(0, 3 * total + 1):
        want = min(cap, float(step) / total)
        got = torch.clamp(torch.tensor(step, dtype=torch.int64).double() / total, max=cap).float()
        assert got.dtype == torch.float32 and got.item() == float(np.float32(want))
        assert torch.equal(got * kl, want * kl), step
    params = model.init_params(torch.Generator().manual_seed(0))
    users = torch.arange(12)
    batch = {"users": users, "rows": model.make_rows(users)}
    for step in (0, 2, total, 4 * total):
        losses = [model.loss(params, dict(batch, step=s, generator=torch.Generator().manual_seed(3)), torch.ones(12))
                  for s in (step, torch.tensor(step))]
        assert torch.equal(losses[0], losses[1]), step


def test_apr_switch_is_fixed_by_the_epoch(tmp_path):
    """APR's adversarial term is on from ``adv_epoch`` (2 here): a run of
    steps takes the epoch as a constant, so epoch 1 equals adv off and
    epoch 2 differs from it."""
    trainer = trainer_for("apr", tmp_path)
    draws = trainer.draw_epoch(trainer.epoch_generator(1))
    losses = {}
    for epoch in (1, 2):
        params, opt = clone(trainer)
        losses[epoch] = trainer.run_epoch(params, opt, *draws, epoch=epoch)[2]
    trainer.model.reg_adv = 0.0
    params, opt = clone(trainer)
    off = trainer.run_epoch(params, opt, *draws, epoch=2)[2]
    assert torch.equal(losses[1], off) and not torch.equal(losses[2], off)


def test_scan_unroll_is_read_as_the_jax_trainer_reads_it(tmp_path):
    for raw, want in ((None, 1), (0, 1), (1, 1), (4, 4), ("8", 8), (-3, 1)):
        model, ds, conf = build("mf")
        extra = {} if raw is None else {"scan_unroll": raw}
        trainer = Trainer(model, ds, DictConfig(dict(CONFS["mf"], **extra)), logger=SilentLogger(), device="cpu")
        assert trainer.scan_unroll == want, raw
        assert trainer.graphs and not trainer._captures()  # the CPU runs eagerly
    assert not Trainer(model, ds, conf, logger=SilentLogger(), device="cpu", graphs=False).graphs


def test_every_built_in_epoch_model_is_held_here():
    """The models of the built-in epochs (every registered model but those
    of the ``custom`` and ``none`` kinds) are the 23 this file runs, so a
    new one is held to the plain loop too."""
    built_in = {name for name in registered_models() if get_model(name).data_kind not in ("custom", "none")}
    held = {CONFS[k]["recommender"] for k in CONFS} | {"DiffNet"}
    assert built_in == held and len(held) == 23
