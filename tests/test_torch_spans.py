"""The program's spans (``profiling.span``), on the CPU.

Held here, through a LightGCN trainer, its evaluator and ``batch_topk``:

* off (no profiler, no ``tracing()`` block) nothing is recorded, and an
  off span yields None;
* under ``device_trace`` every stored span has a ``user_annotation`` twin
  in the exported trace: the same names, in the same order, the same
  count, each nested inside its parent's;
* every name starts with ``neurec.`` and none is a name the benchmark
  gives its own ranges;
* the attributes: a call's ``captured`` is what ``KeptSteps``, the
  evaluator's and the export's programs captured in it (through the stub
  graph runner of ``tests/test_torch_step_graph.py``), a kept run
  released and an export the LRU dropped when the ninth key arrived
  included, and the serving request's ``h2d_bytes`` is the size computed
  from the request;
* losses, params, metric strings, ids and scores are the same bits with
  tracing on and off;
* ``StepTimer.phase`` nests its spans and ``count`` adds to the top one.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from neurec_tpu_torch import profiling, recommend, step_graph
from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import graph
from neurec_tpu_torch.profiling import StepTimer
from neurec_tpu_torch.recommend import batch_topk
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_step_graph import ReplayingGraphs
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "neurec_tpu_torch")
# the benchmark's own ranges (perfbench/tracing.py, perfbench/jobs/)
BENCHMARK_SPANS = {"window", "draw", "run", "evaluate", "request"}
CONF = dict(recommender="LightGCN", embed_size=8, n_layers=2, reg=0.01, adj_type="pre", batch_size=48,
            learner="adam", learning_rate=0.01, topk=[5, 10], metric=["Recall", "NDCG"], test_batch_size=16)


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(graph, "DENSE_LIMIT", 0)  # the plan SpMM (K2's plain version)
    profiling.reset()
    yield
    profiling.reset()


def trainer(seed=7):
    ds = random_dataset(num_users=40, num_items=60, seed=1)
    conf = DictConfig(CONF)
    model = get_model("LightGCN")(ds, conf, device="cpu")
    t = Trainer(model, ds, conf, logger=SilentLogger(), seed=seed, device="cpu")
    t.initialize()
    return t, ds


@pytest.fixture
def captured(monkeypatch):
    """The CUDA side stubbed: the kept steps, the evaluator's and the
    export's programs capture and replay on the CPU where they would on a
    card."""
    made = []

    def graphs(device):
        made.append(ReplayingGraphs(device))
        return made[-1]

    monkeypatch.setattr(step_graph, "_CudaGraphs", graphs)
    monkeypatch.setattr(step_graph, "captures", lambda device, graphs=True, mesh=None: graphs)
    return made


def work(t, ds, epochs=(1, 2)):
    """Epochs as the benchmark runs them (a draw, then its run), an
    evaluation and two serving requests: what each produced."""
    losses = []
    for e in epochs:
        draws = t.draw_epoch(t.epoch_generator(e))
        t.params, t.opt_state, loss = t.run_epoch(t.params, t.opt_state, *draws, epoch=e)
        losses.append(loss)
    result = t.evaluate()
    users = np.arange(0, 30, dtype=np.int32)
    served = [batch_topk(t.model, t.params, 5, users=users, batch_size=8, train_matrix=ds.train_matrix,
                         device="cpu") for _ in range(2)]
    return losses, result, served


def by_name(name):
    return [s for s in profiling.spans() if s.name == name]


@pytest.mark.parametrize("call", ["train_epoch", "evaluate", "batch_topk"])
def test_off_records_nothing(call):
    t, ds = trainer()
    if call == "train_epoch":
        t.train_epoch(1)
    elif call == "evaluate":
        t.evaluate()
    else:
        batch_topk(t.model, t.params, 5, train_matrix=ds.train_matrix, device="cpu")
    assert profiling.spans() == [] and profiling.summary() == ""
    with profiling.span("neurec.off") as sp:
        assert sp is None
    profiling.count(captured=1)
    assert profiling.spans() == []


def test_tracing_block_records_without_a_profiler():
    t, ds = trainer()
    with profiling.tracing():
        with profiling.tracing():
            t.train_epoch(1)
        t.evaluate()
    t.train_epoch(2)  # off again
    names = [s.name for s in profiling.spans()]
    assert names.count("neurec.draw_epoch") == names.count("neurec.run_epoch") == 1
    assert names.count("neurec.evaluate") == 1
    for s in profiling.spans():
        assert s.end_ns >= s.start_ns


def _annotations(path):
    with open(path) as fin:
        events = json.load(fin)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith("neurec.")]


def test_store_matches_the_trace(tmp_path, captured):
    t, ds = trainer()
    with profiling.device_trace(str(tmp_path / "trace"), device="cpu") as out:
        work(t, ds)
    stored = profiling.spans()
    assert {s.name for s in stored} >= {
        "neurec.draw_epoch", "neurec.draw.perm", "neurec.draw.negatives", "neurec.draw.seeds", "neurec.run_epoch",
        "neurec.steps.inputs", "neurec.steps.counts", "neurec.steps.capture", "neurec.steps.replay",
        "neurec.evaluate", "neurec.program.capture", "neurec.eval.read", "neurec.batch_topk", "neurec.serve.edges",
        "neurec.serve.h2d", "neurec.program.replay", "neurec.serve.read"}
    events = _annotations(out.path)
    assert len(events) == len(stored)
    # the exported order is the order the ranges opened
    assert [e["name"] for e in events] == [s.name for s in stored]
    ordered = sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in ordered] == [s.name for s in stored]
    for s in stored:
        if s.parent is not None:
            outer, inner = events[s.parent], events[s.index]
            assert outer["name"] == stored[s.parent].name
            assert float(outer["ts"]) <= float(inner["ts"])
            assert float(inner["ts"]) + float(inner["dur"]) <= float(outer["ts"]) + float(outer["dur"]) + 1.0
        assert stored[s.call].parent is None


def test_names_are_the_programs_own(captured):
    t, ds = trainer()
    with profiling.tracing():
        work(t, ds)
        t.train_epoch(3)
    seen = {s.name for s in profiling.spans()}
    # and every name the package's sources open
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fin:
                    seen |= set(re.findall(r"\bspan\(\"([^\"]+)\"", fin.read()))
    assert len(seen) >= 18
    for name in seen:
        assert name.startswith("neurec.") and name not in BENCHMARK_SPANS, name


def test_training_attributes(captured):
    t, ds = trainer()
    with profiling.tracing():
        for e in (1, 2):
            draws = t.draw_epoch(t.epoch_generator(e))
            t.run_epoch(t.params, t.opt_state, *draws, epoch=e)
            if e == 1:
                first = t.kept["epoch"].captured
    assert first >= 1 and captured[0].captured  # the stub's captures
    draw, run = by_name("neurec.draw_epoch"), by_name("neurec.run_epoch")
    assert len(draw) == len(run) == 2
    (capture,) = by_name("neurec.steps.capture")
    assert first == len(captured[0].captured)
    assert [s.attrs.get("captured", 0) for s in run] == [first, 0]
    assert capture.parent == run[0].index and capture.call == run[0].index
    # the second call copies its inputs and refills Adam's count tables
    (inputs,), (counts,) = by_name("neurec.steps.inputs"), by_name("neurec.steps.counts")
    assert inputs.call == counts.call == run[1].index
    replays = by_name("neurec.steps.replay")
    assert [s.call for s in replays] == [run[0].index, run[1].index]
    for s in draw:
        children = [c.name for c in profiling.spans() if c.parent == s.index]
        assert children == ["neurec.draw.perm", "neurec.draw.negatives", "neurec.draw.seeds"]


def test_a_released_kept_run_is_counted(captured):
    t, _ = trainer()
    with profiling.tracing():
        draws = t.draw_epoch(t.epoch_generator(1))
        t.run_epoch(t.params, t.opt_state, *draws, epoch=1)
        t.scan_unroll += 1  # the kept run no longer holds
        t.run_epoch(t.params, t.opt_state, *draws, epoch=2)
    run = by_name("neurec.run_epoch")
    first = len(captured[0].captured)
    assert first >= 1 and run[0].attrs["captured"] == first
    # the released run's successor captures anew, in the second call
    assert run[1].attrs["captured"] == len(captured[1].captured) >= 1
    assert [s.call for s in by_name("neurec.steps.capture")] == [run[0].index, run[1].index]


def test_evaluation_attributes(captured):
    t, _ = trainer()
    with profiling.tracing():
        t.evaluate()
        t.evaluate()
    calls = by_name("neurec.evaluate")
    assert [s.attrs.get("captured", 0) for s in calls] == [2, 0]
    (capture,), (replay,) = by_name("neurec.program.capture"), by_name("neurec.program.replay")
    assert capture.call == calls[0].index and replay.call == calls[1].index
    assert [s.call for s in by_name("neurec.eval.read")] == [c.index for c in calls]


def test_serving_attributes(captured):
    t, ds = trainer()
    users = np.array([3, 1, 4, 15, 9, 26, 5, 35, 8, 7, 2], dtype=np.int32)
    B, k = 4, 6
    with profiling.tracing():
        batch_topk(t.model, t.params, k, users=users, batch_size=B, train_matrix=ds.train_matrix, device="cpu")
        batch_topk(t.model, t.params, k, users=users, batch_size=B, train_matrix=ds.train_matrix, device="cpu")
    n_batches = 3
    csr = ds.train_matrix.tocsr()
    deg = np.diff(csr.indptr)[users]
    e_max = max(1 << int(max(deg[lo:lo + B].sum() for lo in range(0, len(users), B)) - 1).bit_length(), 8)
    first, second = by_name("neurec.batch_topk")
    copies = by_name("neurec.serve.h2d")
    assert [s.call for s in copies] == [first.index, second.index]
    # users (n_batches, B) and edge items and slots (n_batches, e_max), as the int64 buffers hold them
    assert [s.attrs["h2d_bytes"] for s in copies] == [8 * (n_batches * B + 2 * n_batches * e_max)] * 2
    assert (first.attrs["captured"], second.attrs.get("captured", 0)) == (2, 0)
    children = [c.name for c in profiling.spans() if c.parent == second.index]
    assert children == ["neurec.serve.edges", "neurec.serve.h2d", "neurec.program.replay", "neurec.serve.read"]


def test_the_ninth_export_key_evicts(captured):
    t, _ = trainer()
    recommend.EXPORTS.release()
    with profiling.tracing():
        for k in range(1, 10):
            batch_topk(t.model, t.params, k, users=np.arange(10, dtype=np.int32), device="cpu")
        # new params: the program is captured anew
        moved = {key: [v.clone() for v in leaf] if isinstance(leaf, list) else leaf.detach().clone()
                 for key, leaf in t.params.items()}
        batch_topk(t.model, moved, 9, users=np.arange(10, dtype=np.int32), device="cpu")
        # the first key was dropped when the ninth arrived: captured anew
        batch_topk(t.model, t.params, 1, users=np.arange(10, dtype=np.int32), device="cpu")
    assert len(recommend.EXPORTS) == recommend.EXPORTS.most
    calls = by_name("neurec.batch_topk")
    assert [s.attrs["captured"] for s in calls] == [2] * 11
    recommend.EXPORTS.release()


def test_outputs_are_the_same_bits_on_and_off(captured):
    got = {}
    for on in (False, True):
        t, ds = trainer()
        with profiling.tracing() if on else profiling._OFF:
            losses, result, served = work(t, ds, epochs=(1, 2, 3))
        got[on] = (losses, result, served, [p.detach().clone() for _, p in param_leaves(t.params)])
        recommend.EXPORTS.release()
    (l0, r0, s0, p0), (l1, r1, s1, p1) = got[False], got[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert r0 == r1
    for (i0, v0), (i1, v1) in zip(s0, s1):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert profiling.spans()


def test_step_timer_phases_nest_and_count():
    timer = StepTimer()
    with timer.phase("outer", steps=3) as outer:
        with timer.phase("inner") as inner:
            timer.count(captured=2)
        timer.count(captured=1, released=1)
    with timer.phase("outer"):
        pass
    assert [r.name for r in timer.records] == ["outer", "inner", "outer"]
    assert (outer.parent, inner.parent, timer.records[2].parent) == (None, 0, None)
    assert (outer.call, inner.call, timer.records[2].call) == (0, 0, 2)
    assert outer.attrs == {"steps": 3, "captured": 3, "released": 1} and inner.attrs == {}
    assert timer.counts == {"outer": 2, "inner": 1}
    assert timer.totals["outer"] >= timer.totals["inner"] >= 0.0
    assert timer.summary().splitlines()[0].startswith("inner")
    timer.reset()
    assert timer.records == [] and timer.summary() == ""
