"""The arithmetic of the traced window: busy time as a union of
intervals, idle gaps named by the spans, kernel families."""

import pytest

from perfbench import tracing


def test_union_clips_and_merges():
    assert tracing.union_s([(0, 10), (5, 15), (20, 30)], 0, 100) == pytest.approx(25e-6)
    assert tracing.union_s([(-5, 5), (95, 120)], 0, 100) == pytest.approx(10e-6)
    assert tracing.union_s([(0, 100), (10, 20)], 0, 100) == pytest.approx(100e-6)
    assert tracing.union_s([], 0, 100) == 0


def test_idle_gaps():
    assert tracing.idle_gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert tracing.idle_gaps([(0, 100)], 0, 100) == []


def _trace():
    return [
        {"cat": "user_annotation", "name": "window", "ts": 0, "dur": 1000},
        {"cat": "user_annotation", "name": "draw", "ts": 0, "dur": 300},
        {"cat": "user_annotation", "name": "run", "ts": 300, "dur": 700},
        {"cat": "kernel", "name": "void span_spmm_kernel<float>(...)", "ts": 350, "dur": 40},
        {"cat": "kernel", "name": "span_fixup_kernel(...)", "ts": 390, "dur": 10},
        {"cat": "kernel", "name": "void span_spmm_kernel<float>(...)", "ts": 500, "dur": 50},
        {"cat": "kernel", "name": "masked_scores_tma_kernel(...)", "ts": 600, "dur": 100},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 100, "dur": 20},
        {"cat": "cpu_op", "name": "aten::add", "ts": 10, "dur": 5},
        {"cat": "gpu_user_annotation", "name": "run", "ts": 300, "dur": 700},
    ]


def test_parse_trace_families_and_spans():
    (lo, hi), ops, spans, fam_s, fam_n = tracing.parse_trace(_trace(), ("k1", "k2"))
    assert (lo, hi) == (0, 1000)
    assert len(ops) == 5
    assert [s[0] for s in spans] == ["draw", "run"]
    assert fam_n == {"k1": 1, "k2": 2}
    assert fam_s["k2"] == pytest.approx(100e-6)
    assert fam_s["k1"] == pytest.approx(100e-6)


def test_breakdown_names_gaps_by_span():
    (lo, hi), ops, spans, fam_s, fam_n = tracing.parse_trace(_trace(), ("k2",))
    w = tracing.Window((hi - lo) / 1e6, tracing.union_s([(t, t + d) for _, t, d in ops], lo, hi), ops, spans, lo,
                       fam_s, fam_n, 0)
    assert w.busy_s == pytest.approx(220e-6)
    b = tracing.breakdown(w)
    assert b["idle_gaps"][0] == ["run", pytest.approx(300e-6)]  # 700 .. 1000
    assert b["idle_gaps"][1][0] == "draw"
    assert b["device_ops"][0] == ["masked_scores_tma_kernel", pytest.approx(100e-6)]
    assert tracing.span_device_s(w, "run") == pytest.approx(200e-6)


def test_a_trace_without_window_is_refused():
    with pytest.raises(RuntimeError):
        tracing.parse_trace([{"cat": "kernel", "name": "k", "ts": 0, "dur": 1}], ())
