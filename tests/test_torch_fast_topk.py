"""``ops/fast_topk.py::exact_topk_indices`` against the JAX function (on the
CPU, where ``approx_max_k`` is exact) and against ``ops/topk.py::top_k``.

The six cases of ``tests/test_fast_topk.py`` (random, ties at the
boundary, ``-inf`` rows, overflow, a ragged length, fewer finite values
than k and ``k > I``), and a few more shapes: wherever the port's overflow
is 0 its ids equal ``top_k``'s (and so ``lax.top_k``'s); its overflow is
never below the JAX function's (its threshold is no higher); where both are
0 the ids are the JAX function's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops.fast_topk import exact_topk_indices as jax_exact_topk_indices
from neurec_tpu_torch.ops.fast_topk import exact_topk_indices
from neurec_tpu_torch.ops.topk import top_k


def _check(x, k, **kw):
    """(port ids, port overflow) after holding them to top_k and to JAX."""
    idx, ovf = exact_topk_indices(torch.from_numpy(x), k, **kw)
    assert idx.dtype == torch.int32 and idx.shape == (x.shape[0], k) and ovf.dtype == torch.int32
    ovf = int(ovf)
    idx_j, ovf_j = jax.jit(lambda a: jax_exact_topk_indices(a, k, **kw))(jnp.asarray(x))
    want = top_k(torch.from_numpy(x), k)[1]
    want_j = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    np.testing.assert_array_equal(want.numpy(), want_j)  # the oracle is lax.top_k's
    assert ovf >= int(ovf_j)
    if ovf == 0:
        np.testing.assert_array_equal(idx.numpy(), want.numpy())
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    return idx.numpy(), ovf


def test_random_matches_topk():
    x = np.random.default_rng(0).standard_normal((64, 5000)).astype(np.float32)
    assert _check(x, 20)[1] == 0


def test_ties_at_boundary_match_topk():
    x = np.random.default_rng(1).integers(0, 30, (32, 4000)).astype(np.float32)
    assert _check(x, 20)[1] == 0


def test_masked_rows_with_neg_inf():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 3000)).astype(np.float32)
    x[rng.random((16, 3000)) < 0.3] = -np.inf
    assert _check(x, 10)[1] == 0


def test_overflow_detected_not_silent():
    x = np.random.default_rng(3).standard_normal((8, 4096)).astype(np.float32)
    assert _check(x, 20, seg=128, max_hot=2)[1] > 0


def test_non_segment_multiple_length():
    x = np.random.default_rng(4).standard_normal((16, 1203)).astype(np.float32)
    assert _check(x, 20)[1] == 0


def test_fewer_than_k_finite_values_stays_exact_and_k_gt_I_rejected():
    I, k = 200, 16
    x = np.full((2, I), -np.inf, np.float32)
    x[0, :3] = [5.0, 4.0, 3.0]
    x[1, :50] = np.arange(50, dtype=np.float32)
    idx, ovf = _check(x, k)
    assert idx.max() < I
    with pytest.raises(ValueError, match="k <= row length"):
        exact_topk_indices(torch.from_numpy(x[:, :8]), k)


@pytest.mark.parametrize("shape,k,kw", [
    ((6, 300), 20, dict(seg=32, max_hot=16)),     # fewer segments than k's hot set
    ((5, 100), 20, dict(seg=128)),                # one segment, n_seg < k: the exact threshold
    ((9, 2000), 50, dict(seg=64, max_hot=40)),    # K 50 as the probe's
    ((4, 38546), 20, {}),                         # gowalla's catalogue
])
def test_more_shapes(shape, k, kw):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, rng.integers(0, shape[1], 5)] = x.max()  # a tie at the top
    _check(x, k, **kw)


def test_many_hot_segments_overflow_at_least_jax():
    """Top values spread over every segment: overflow in both, the port's
    no lower."""
    x = np.tile(np.arange(128, dtype=np.float32), (3, 32))  # 32 equal segments
    _, ovf = _check(x, 40, seg=128, max_hot=4)
    assert ovf == 3


def test_the_probe_checks_the_ids_and_reports_every_call(monkeypatch):
    """``benchmarks/topk_ab.py::run`` on the CPU at a small shape, its
    timers stubbed (they time on the card): each call is run and reported,
    the overflow and the id check as ``exact_topk_indices`` gives them."""
    from neurec_tpu_torch.benchmarks import topk_ab

    ran = []
    monkeypatch.setattr(topk_ab, "_events_ms", lambda fn, iters: (fn(), 0.0)[1])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 9000)).astype(np.float32))
    rep = topk_ab.run({"randn": x}, ks=(20,), iters=1, device_ms=lambda fn: ran.append(fn()) or None)
    rec = rep["randn/k20"]
    assert rec["overflow"] == 0 and rec["ids_equal"] and rec["rows_differing"] == 0
    assert rec["read_bytes"] == 8 * 9000 * 4
    assert set(rec) >= {"top_k", "exact", "rowmax", "torch_topk", "tie_cumsum", "exact_rerank"}
    assert len(ran) == 6
