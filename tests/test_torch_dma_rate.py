"""K4 (the copy-rate probe) in the port against the JAX package's TPU
probe, on the CPU.

The JAX kernels (``benchmarks/dma_rate.py``'s own ``_serial_kernel`` and
``_pipelined_kernel``, loaded by path) run in Pallas interpret mode, where
rows that no copy writes read NaN; the port's plain version writes 1.0 into
a zeroed buffer. The rows each one writes must be the same set, and every
written row must hold the tile (1.0 in all 128 columns). The probe's entry
point refuses to write under ``benchmarks/`` and to measure without a card.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neurec_tpu_torch.benchmarks import dma_rate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location("tpu_dma_rate", os.path.join(REPO, "benchmarks", "dma_rate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_buffer(mod, offs, n_dma, rows, mode):
    if mode == "serial":
        kernel = functools.partial(mod._serial_kernel, len(offs), n_dma, rows)
    else:
        kernel = functools.partial(mod._pipelined_kernel, len(offs), n_dma, rows, dma_rate.N_OUTSTANDING)
    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,), in_specs=[], out_specs=pl.BlockSpec(memory_space=pl.ANY)),
        out_shape=jax.ShapeDtypeStruct((mod.OUT_ROWS, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(offs))
    return np.asarray(out)


@pytest.mark.parametrize("mode", dma_rate.MODES)
@pytest.mark.parametrize("rows", dma_rate.ROWS_LIST)
@pytest.mark.parametrize("n_offs,n_dma", [(40, 100), (40, 25)])
def test_plain_version_writes_the_rows_the_jax_kernel_writes(jax_probe, mode, rows, n_offs, n_dma):
    assert jax_probe.OUT_ROWS == dma_rate.OUT_ROWS
    offs = np.random.RandomState(rows + n_dma).randint(0, dma_rate.OUT_ROWS - rows, n_offs).astype(np.int32)
    offs[1] = offs[0] + 1  # overlapping copies
    want = _jax_buffer(jax_probe, offs, n_dma, rows, mode)
    written_j = (want == 1.0).all(axis=1)
    assert (np.isnan(want[~written_j])).all()  # the rest untouched
    got = dma_rate.dma_copies_reference(torch.from_numpy(offs), n_dma, rows).numpy()
    written = (got == 1.0).all(axis=1)
    assert (got[~written] == 0.0).all()
    np.testing.assert_array_equal(written, written_j)
    assert written.sum() == len(np.unique((offs[:n_dma, None] + np.arange(rows)).ravel()))
    # the wrapper on a CPU buffer is the plain version
    buf = dma_rate.new_buffer("cpu")
    np.testing.assert_array_equal(dma_rate.dma_copies(torch.from_numpy(offs), n_dma, rows, mode, buf).numpy(), got)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    offs = torch.zeros(4, dtype=torch.int32)
    buf = dma_rate.new_buffer("cpu")
    with pytest.raises(ValueError):
        dma_rate.dma_copies(offs, 4, 2, "serial", buf)  # rows not 1, 4 or 16
    with pytest.raises(ValueError):
        dma_rate.dma_copies(offs, 4, 1, "burst", buf)
    with pytest.raises(TypeError):
        dma_rate.dma_copies(offs.long(), 4, 1, "serial", buf)
    with pytest.raises(ValueError):
        dma_rate.dma_copies(offs, 4, 1, "serial", torch.zeros(10, 128))


def test_probe_needs_a_card_and_never_writes_under_benchmarks(monkeypatch):
    with pytest.raises(SystemExit, match="must not write"):
        dma_rate.main(["--out", os.path.join(REPO, "benchmarks", "dma_rate.json")])
    with pytest.raises(RuntimeError, match="CUDA device"):
        dma_rate.measure(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dma_rate.measure()
