"""Training epochs as CUDA-graph programs kept across epochs
(``step_graph.KeptSteps``), on a card. These tests need an NVIDIA GPU (CUDA
graphs and the kernels have no CPU mode) and skip without one. The file
imports neither jax nor neurec_tpu:
    python -m pytest tests/test_torch_kept_epochs_cuda.py -m cuda --noconftest -q

For each of the 32 stepped models (the 23 of the built-in epochs, the 9
custom ones) at the small widths of ``tests/test_torch_step_graph_cuda.py``
and ``tests/test_torch_custom_graph_cuda.py``, from one seed, three epoch
calls of a trainer that keeps its programs (``scan_unroll`` 1) must give
the epoch losses, params and optimizer state of three eager calls
(``Trainer(graphs=False)``) bit for bit, or, where two eager runs differ
too (atomics), within ``ATOL``; the first call captures and the second and
third capture no graph. The same holds at ``scan_unroll`` 3 over runs of 5
steps, which do not divide: the first call captures the graphs of 3 steps,
of its remainder of 1 and of the later calls' remainder of 2, and the later
calls replay the graphs of 3 and 2, out of their capture order. GRU4Rec's
live prefix changes its steps from epoch to epoch (206, 214, 207 here): at
``scan_unroll`` 3 and 4 one kept program takes them all, a later call
capturing just the remainder graphs of counts not held before. IRGAN's
draws repeat while another stream keeps the card busy. APR's
adversarial term turns on at ``adv_epoch`` through the kept graphs, and a
changed ``NEUREC_SPMM_PACK`` captures anew and takes K3.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.general.irgan import categorical
from neurec_tpu_torch.ops import _build, graph
from neurec_tpu_torch.step_graph import KeptSteps
from neurec_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda


def _sibling(name):
    """A card test module beside this one, loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(__file__), name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STEP = _sibling("test_torch_step_graph_cuda")
CUSTOM = _sibling("test_torch_custom_graph_cuda")
DIFFNET = dict(STEP.EVAL, recommender="DiffNet", embedding_size=16, batch_size=64, num_negatives=2,
               learner="adam", learning_rate=0.01, feature_dimension=6, user_feature_file="", item_feature_file="")
BUILT_IN = sorted(set(STEP.CONFS) - {"ngcf-node"}) + ["diffnet"]
MODELS = BUILT_IN + sorted(CUSTOM.CONFS)
# two eager runs that differ (atomics: a gather's backward, NGCF's node
# dropout) hold the kept run within this
ATOL = 1e-5
EPOCHS = (1, 2, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data(name, tmp_path, over):
    if name in CUSTOM.CONFS:
        return CUSTOM.dataset(name, tmp_path)
    ds = random_dataset(num_users=300, num_items=400, min_per_user=4, max_per_user=24, seed=3)
    conf = dict(DIFFNET if name == "diffnet" else STEP.CONFS[name], **over)
    if name == "diffnet":  # a friendship file of 4 friends a user
        ds.userids = {u: u for u in range(ds.num_users)}
        ds.itemids = {i: i for i in range(ds.num_items)}
        rng = np.random.RandomState(0)
        path = os.path.join(str(tmp_path), "friends.uu")
        with open(path, "w") as f:
            f.write("".join("%d,%d\n" % (u, v) for u in range(ds.num_users)
                            for v in rng.choice(ds.num_users, 4, replace=False)))
        conf.update({"social_file": path, "data.convert.separator": ","})
    return ds, DictConfig(conf)


def trainer(name, tmp_path, graphs, monkeypatch, **over):
    if name in ("lightgcn", "ngcf"):  # the plan SpMM: K2 both ways
        monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    ds, conf = _data(name, tmp_path, over)
    model = get_model(conf["recommender"])(ds, conf, device="cuda")
    t = Trainer(model, ds, conf, seed=7, device="cuda", graphs=graphs, logger=STEP._Silent())
    t.initialize()
    return t


def three_epochs(t, max_steps=None):
    """Three epoch calls: each call's loss, params and optimizer tensors,
    and the graphs each kept run captured in it."""
    out = []
    for epoch in EPOCHS:
        t.params, t.opt_state, loss = t.train_epoch(epoch, max_steps=max_steps)
        torch.cuda.synchronize()
        tensors = [loss.clone()] + [p.detach().clone() for _, p in param_leaves(t.params)] + \
            [v.clone() for v in CUSTOM._opt_tensors(t.opt_state)]
        out.append((tensors, {k: kept.captured for k, kept in t.kept.items()}))
    return out


def max_diff(a, b):
    assert len(a) == len(b)
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0 for x, y in zip(a, b))


def kept_and_eager(name, tmp_path, monkeypatch, unroll=1, max_steps=None):
    """Three epoch calls of an eager trainer, of a second one (the control)
    and of one that keeps its programs at ``unroll``; the kept calls are
    held to the eager ones (to the bit where the control is) and the kept
    trainer is returned with its calls."""
    eager, control, kept = (trainer(name, tmp_path, g, monkeypatch) for g in (False, False, True))
    kept.scan_unroll = unroll
    assert not eager._captures() and kept._captures()
    want, again = three_epochs(eager, max_steps), three_epochs(control, max_steps)
    got = three_epochs(kept, max_steps)
    assert kept.kept and not eager.kept
    for epoch, ((w, _), (a, _), (g, _)) in enumerate(zip(want, again, got), 1):
        assert torch.isfinite(w[0]), (name, epoch)
        if max_diff(w, a) == 0.0:
            assert max_diff(w, g) == 0.0, (name, epoch, max_diff(w, g))
        else:
            assert max_diff(w, g) <= ATOL, (name, epoch, max_diff(w, a), max_diff(w, g))
    return kept, got


@pytest.mark.parametrize("name", MODELS)
def test_kept_epochs_equal_the_eager_ones(cuda, name, tmp_path, monkeypatch):
    kept, got = kept_and_eager(name, tmp_path, monkeypatch)
    programs = dict(kept.kept)
    for epoch, (_, captured) in enumerate(got[1:], 2):
        assert not any(captured.values()), (name, epoch, captured)
    assert all(kept.kept[k] is programs[k] and programs[k].calls >= 3 for k in programs)


@pytest.mark.parametrize("name", ["lightgcn", "ngcf", "apr", "multivae", "deepicf", "sasrec", "srgnn", "jca",
                                  "cfgan", "irgan", "gru4rec"])
def test_kept_steps_that_do_not_divide_capture_nothing_past_the_first_call(cuda, name, tmp_path, monkeypatch):
    kept, got = kept_and_eager(name, tmp_path, monkeypatch, unroll=3, max_steps=5)
    for epoch, (_, captured) in enumerate(got[1:], 2):
        assert not any(captured.values()), (name, epoch, captured)
    # the graph of 3, the first call's remainder of 1, the later calls' of 2
    assert all(sorted(program.graphs.graphs) == [1, 2, 3] for program in kept.kept.values()), name


@pytest.mark.parametrize("unroll", [3, 4])
def test_gru4rec_live_prefix_changes_the_steps_of_one_program(cuda, unroll, tmp_path, monkeypatch):
    counts = []
    real = KeptSteps.run

    def run(self, steps):
        counts.append(steps.n)
        return real(self, steps)

    monkeypatch.setattr(KeptSteps, "run", run)
    kept, got = kept_and_eager("gru4rec", tmp_path, monkeypatch, unroll=unroll)
    assert len(counts) == 3 and len(set(counts)) > 1, counts
    program = kept.kept["epoch"]
    # the first call captures the graph of unroll steps, its remainder and a
    # later call of the same steps' remainder; a later call, the remainder
    # of its count where no graph of it is held
    held = {unroll, (counts[0] - 1) % unroll, counts[0] % unroll} - {0}
    for n, (_, captured) in zip(counts[1:], got[1:]):
        new = {n % unroll} - held - {0}
        assert captured["epoch"] == len(new), (counts, captured)
        held |= new
    assert set(program.graphs.graphs) == held and program.calls == 3


def test_irgan_draws_do_not_depend_on_the_timing(cuda):
    """IRGAN's one-row draws over 38,546 items (gowalla's catalogue) repeat
    to the bit while a second stream keeps the card busy, as a kept G pass
    needs to equal the eager one."""
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(1, 38546, device="cuda", generator=g) * 4
    busy = torch.randn(4096, 4096, device="cuda", generator=g)
    other = torch.cuda.Stream()
    want = categorical(torch.Generator(device="cuda").manual_seed(7), logits, 64)
    for _ in range(200):
        with torch.cuda.stream(other):
            busy @ busy
        assert torch.equal(categorical(torch.Generator(device="cuda").manual_seed(7), logits, 64), want)
    torch.cuda.synchronize()


def test_apr_adversarial_term_switches_on_at_adv_epoch(cuda, tmp_path, monkeypatch):
    on = three_epochs(trainer("apr", tmp_path, True, monkeypatch, adv_epoch=2))
    off = three_epochs(trainer("apr", tmp_path, True, monkeypatch, adv_epoch=2, reg_adv=0.0))
    losses = [(a[0][0], b[0][0]) for a, b in zip(on, off)]
    assert torch.equal(*losses[0])
    assert not torch.equal(*losses[1]) and not torch.equal(*losses[2])


def test_a_changed_pack_captures_anew_and_takes_k3(cuda, tmp_path, monkeypatch):
    t = trainer("lightgcn", tmp_path, True, monkeypatch, embed_size=64)  # d * pack a multiple of 128
    monkeypatch.delenv("NEUREC_SPMM_PACK", raising=False)
    t.train_epoch(1)
    first = t.kept["epoch"]
    monkeypatch.setenv("NEUREC_SPMM_PACK", "2")
    _build.reset_launches()
    t.train_epoch(2)
    torch.cuda.synchronize()
    assert t.kept["epoch"] is not first and t.kept["epoch"].captured > 0
    assert _build.LAUNCHES["plan_spmm_packed"] == 3 * t.steps and _build.LAUNCHES["plan_spmm"] == 0
