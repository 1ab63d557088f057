"""The reader of ``hstu_fused_layers.eval``: the ``fused_layers`` attribute
of the ``neurec.hstu.attn`` spans, per call, on hand-built stores. A
program whose spans lack the attribute, or that keeps no span store,
reads 0 or nothing and raises nothing."""

import types

import pytest

from neurec_tpu_torch import profiling
from perfbench import harness
from perfbench.tests.test_perfbench_program_spans import _span, read

METRIC = "hstu_fused_layers.eval"


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def test_hstu_fused_layers(store):
    """0 where the evaluation's spans carry no ``fused_layers`` (a program
    without the fused layer kernels), else their sum over the calls."""
    store.extend([_span("neurec.evaluate", 0, 700.0), _span("neurec.hstu.attn", 1, 0.5, pairs=10, real_pairs=6)])
    assert read(METRIC) == 0
    store.extend([_span("neurec.hstu.attn", 2, 0.5, pairs=10, real_pairs=6, fused_layers=544),
                  _span("neurec.hstu.attn", 3, 0.5, pairs=10, real_pairs=6, fused_layers=544)])
    assert read(METRIC) == pytest.approx(2 * 544 / 3)
    assert METRIC in {m["name"] for m in harness.load_cell(harness.ROOT, "hstu_ml20m.eval_seq").per_layer}


def test_an_empty_store_reads_nothing(store):
    assert read(METRIC) is None


def test_a_program_without_a_store_reads_nothing(monkeypatch):
    """A program that keeps no span store (an older one): nothing to read,
    nothing raised."""
    import neurec_tpu_torch

    monkeypatch.setattr(neurec_tpu_torch, "profiling", types.ModuleType("profiling"))
    assert read(METRIC) is None
