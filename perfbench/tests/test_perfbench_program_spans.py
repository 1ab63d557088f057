"""The readers of the program's own spans (``perfbench/layer_metrics``),
on hand-built stores: one window, two windows (a window the launch
check opened again), an empty store and a program that keeps none; and
the traced window's idle gaps named by the innermost span where the
program's spans nest inside the benchmark's."""

import types

import pytest

from neurec_tpu_torch import profiling
from perfbench import harness, tracing

READERS = ("serve_edges_ms_per_request", "serve_h2d_bytes_per_request", "graph_captures.train",
           "graph_captures.eval", "graph_captures.serve")


def _span(name, index, ms, parent=None, **attrs):
    """A closed span of ``ms`` milliseconds."""
    s = profiling.Span(name, index, parent, attrs)
    s.start_ns, s.end_ns = 1_000_000 * index, 1_000_000 * index + int(ms * 1e6)
    return s


def _train_window(at, captured=0):
    draw = _span("neurec.draw_epoch", at, 9.2)
    run = _span("neurec.run_epoch", at + 4, 18.4, **({"captured": captured} if captured else {}))
    return [draw, _span("neurec.draw.perm", at + 1, 0.1, draw), _span("neurec.draw.negatives", at + 2, 1.0, draw),
            _span("neurec.draw.seeds", at + 3, 0.1, draw), run, _span("neurec.steps.inputs", at + 5, 0.1, run),
            _span("neurec.steps.replay", at + 6, 9.2, run)]


def _request(at, edges_ms, h2d, captured=0):
    top = _span("neurec.batch_topk", at, 10.0, **({"captured": captured} if captured else {}))
    return [top, _span("neurec.serve.edges", at + 1, edges_ms, top),
            _span("neurec.serve.h2d", at + 2, 0.2, top, h2d_bytes=h2d),
            _span("neurec.program.replay", at + 3, 0.5, top), _span("neurec.serve.read", at + 4, 1.0, top)]


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def read(metric):
    return harness.layer_reader(harness.ROOT, metric)({"untraced": {}, "traced": {}})


def test_training_captures_one_and_two_windows(store):
    store.extend(_train_window(0))
    store.extend(_train_window(7))
    assert read("graph_captures.train") == 0
    # a second window that captured: over the calls of both
    store.extend(_train_window(14, captured=3))
    assert read("graph_captures.train") == pytest.approx(1.0)
    for metric in ("serve_edges_ms_per_request", "serve_h2d_bytes_per_request"):
        assert read(metric) is None


def test_serving_readers(store):
    store.extend(_request(0, 2.0, 81920))
    store.extend(_request(5, 3.0, 81920, captured=2))
    assert read("serve_edges_ms_per_request") == pytest.approx(2.5)
    assert read("serve_h2d_bytes_per_request") == 81920
    assert read("graph_captures.serve") == pytest.approx(1.0)


def test_evaluation_captures(store):
    store.extend([_span("neurec.evaluate", 0, 26.0), _span("neurec.evaluate", 1, 26.0)])
    assert read("graph_captures.eval") == 0


def test_an_open_span_is_not_read(store):
    store.extend(_request(0, 2.0, 81920))
    store[0].end_ns = None  # the request still open
    assert read("serve_edges_ms_per_request") is None
    assert read("serve_h2d_bytes_per_request") is None


@pytest.mark.parametrize("metric", READERS)
def test_an_empty_store_reads_nothing(store, metric):
    assert read(metric) is None


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_a_store_reads_nothing(monkeypatch, metric):
    """A program that keeps no span store (an older one): nothing to read,
    nothing raised."""
    import neurec_tpu_torch

    monkeypatch.setattr(neurec_tpu_torch, "profiling", types.ModuleType("profiling"))
    assert read(metric) is None


def test_the_readers_are_in_the_manifest():
    cell_metrics = {m["name"] for m in harness.load_cell(harness.ROOT, "lightgcn_gowalla.train").per_layer}
    assert "graph_captures.train" in cell_metrics
    serve = {m["name"] for m in harness.load_cell(harness.ROOT, "ngcf_gowalla.serve").per_layer}
    assert {"serve_edges_ms_per_request", "serve_h2d_bytes_per_request", "graph_captures.serve"} <= serve
    evaluation = {m["name"] for m in harness.load_cell(harness.ROOT, "lightgcn_gowalla.eval").per_layer}
    assert "graph_captures.eval" in evaluation


def test_gaps_take_the_innermost_spans_name():
    """The program's spans nest inside the benchmark's ``draw`` and
    ``request``, each range in the order it opened, as the profiler
    exports them: a gap is named by the innermost range over its middle."""
    events = [
        {"cat": "user_annotation", "name": "window", "ts": 0, "dur": 2000},
        {"cat": "user_annotation", "name": "draw", "ts": 0, "dur": 400},
        {"cat": "user_annotation", "name": "neurec.draw_epoch", "ts": 10, "dur": 350},
        {"cat": "user_annotation", "name": "neurec.draw.perm", "ts": 20, "dur": 30},
        {"cat": "user_annotation", "name": "neurec.draw.negatives", "ts": 60, "dur": 250},
        {"cat": "user_annotation", "name": "neurec.draw.seeds", "ts": 320, "dur": 30},
        {"cat": "user_annotation", "name": "request", "ts": 1000, "dur": 1000},
        {"cat": "user_annotation", "name": "neurec.batch_topk", "ts": 1000, "dur": 990},
        {"cat": "user_annotation", "name": "neurec.serve.edges", "ts": 1010, "dur": 300},
        {"cat": "user_annotation", "name": "neurec.serve.h2d", "ts": 1320, "dur": 20},
        {"cat": "user_annotation", "name": "neurec.program.replay", "ts": 1350, "dur": 50},
        {"cat": "user_annotation", "name": "neurec.serve.read", "ts": 1400, "dur": 580},
        {"cat": "kernel", "name": "randperm_kernel(...)", "ts": 25, "dur": 20},
        {"cat": "kernel", "name": "sample_kernel(...)", "ts": 320, "dur": 25},
        {"cat": "kernel", "name": "topk_kernel(...)", "ts": 1340, "dur": 600},
        {"cat": "kernel", "name": "late(...)", "ts": 1995, "dur": 5},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 950, "dur": 50},
    ]
    (lo, hi), ops, spans, fam_s, fam_n = tracing.parse_trace(events, ())
    w = tracing.Window((hi - lo) / 1e6, tracing.union_s([(t, t + d) for _, t, d in ops], lo, hi), ops, spans, lo,
                       fam_s, fam_n, 0)
    gaps = tracing.breakdown(w)["idle_gaps"]
    assert gaps[0] == ["outside", pytest.approx(605e-6)]  # 345 .. 950: draw ended at 400
    assert gaps[1] == ["neurec.serve.edges", pytest.approx(340e-6)]  # 1000 .. 1340
    assert gaps[2] == ["neurec.draw.negatives", pytest.approx(275e-6)]  # 45 .. 320
    assert gaps[3] == ["neurec.serve.read", pytest.approx(55e-6)]  # 1940 .. 1995
    assert gaps[4] == ["neurec.draw_epoch", pytest.approx(25e-6)]  # 0 .. 25: before the permutation's span
