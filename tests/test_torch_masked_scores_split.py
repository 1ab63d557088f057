"""The numbers of K1's 3xTF32 split, emulated on the CPU.

K1 (``neurec_tpu_torch/csrc/masked_scores.cu``) computes its f32 product on
the tensor cores: each operand x is split into hi = tf32(x) and
lo = tf32(x - hi), and each mma step of depth 8 adds a_lo*b_hi, a_hi*b_lo
and a_hi*b_hi to one f32 accumulator. Here ``round_tf32_reference`` is held
to an independent float64 rounding on edge values and random bit patterns,
and the emulated kernel (exact TF32 products, the accumulator rounded to
f32 after each step) is held to the JAX package's ``masked_scores`` in
interpret mode: atol/rtol 1e-5 with -inf at the same places for d <= 64,
and at d = 256 no farther from the f64 product than JAX's f32 output is
(at d = 256 no two f32 summation orders agree to 1e-5 on randn factors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neurec_tpu.ops import pallas_kernels as jax_k1
from neurec_tpu_torch.ops import masked_scores as k1

torch.set_float32_matmul_precision("highest")


def _tf32_exact(x):
    """TF32 rounding derived in float64 arithmetic: the value's ulp at 10
    mantissa bits (fixed at 2^-136 below the normal range), round half away
    from zero, inf past the largest TF32 value."""
    with np.errstate(invalid="ignore"):  # NaN payloads
        x = np.asarray(x, dtype=np.float32).astype(np.float64)
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    a = np.abs(x[fin])
    e = np.maximum(np.floor(np.log2(a)), -126.0)
    ulp = np.exp2(e - 10)
    r = np.floor(a / ulp + 0.5) * ulp
    r[r >= 2.0 ** 128] = np.inf
    out[fin] = np.sign(x[fin]) * r
    return out.astype(np.float32)


def _same_floats(got, want):
    """Equal bit for bit, NaN matching any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


TIE = 2.0 ** -11  # half a TF32 ulp at 1
EDGES = {  # name: (inputs, expected)
    "ties_away_from_zero": ([1 + TIE, -(1 + TIE), 1 + 3 * TIE, 2 + 2 * TIE, 1 + TIE * (1 - 2 ** -12)],
                            [1 + 2 * TIE, -(1 + 2 * TIE), 1 + 4 * TIE, 2 + 4 * TIE, 1.0]),
    "subnormals": ([2.0 ** -149, 2.0 ** -137, -(2.0 ** -137), 2.0 ** -136, 2.0 ** -126 - 2.0 ** -149],
                   [0.0, 2.0 ** -136, -(2.0 ** -136), 2.0 ** -136, 2.0 ** -126]),
    "signed_zero": ([0.0, -0.0, -(2.0 ** -149)], [0.0, -0.0, -0.0]),
    "largest_finite": ([3.4028234663852886e38, -3.4028234663852886e38, 2.0 ** 127 * (2 - 2.0 ** -10)],
                       [np.inf, -np.inf, 2.0 ** 127 * (2 - 2.0 ** -10)]),
    "inf_and_nan": ([np.inf, -np.inf, np.nan], [np.inf, -np.inf, np.nan]),  # NaN kept
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_round_tf32_edge_values(case):
    x, want = (np.array(v, dtype=np.float32) for v in EDGES[case])
    got = k1.round_tf32_reference(torch.from_numpy(x)).numpy()
    _same_floats(got, want)
    _same_floats(got, _tf32_exact(x))
    _same_floats(k1.round_tf32(torch.from_numpy(x)).numpy(), want)  # CPU dispatch


@pytest.mark.parametrize("seed", [0, 1])
def test_round_tf32_random_bit_patterns(seed):
    bits = np.random.RandomState(seed).randint(0, 2 ** 32, size=200_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    got = k1.round_tf32_reference(torch.from_numpy(x.copy())).numpy()
    _same_floats(got, _tf32_exact(x))
    fin = np.isfinite(got)
    assert not (got[fin].view(np.uint32) & 0x1FFF).any()  # 10 mantissa bits left


def _split(x):
    hi = k1.round_tf32_reference(x)
    return hi, k1.round_tf32_reference(x - hi)


def emulate_split(u, items):
    """K1's product as the kernel forms it: per depth-8 step the three
    TF32 products (exact), added to the accumulator and rounded to f32."""
    uh, ul = _split(u)
    ih, il = _split(items)
    acc = torch.zeros(u.shape[0], items.shape[0], dtype=torch.float32)
    for k in range(0, u.shape[1], 8):
        s = slice(k, k + 8)
        for a, b in ((ul, ih), (uh, il), (uh, ih)):
            acc = (acc.double() + a[:, s].double() @ b[:, s].double().T).float()
    return acc


def _inputs(seed, B, I, d, L, scale=1.0):
    rng = np.random.RandomState(seed)
    u = (rng.randn(B, d) * scale).astype(np.float32)
    items = (rng.randn(I, d) * scale).astype(np.float32)
    rows = np.full((B, L), I, dtype=np.int32)
    for b in range(B):
        n = rng.randint(0, min(L, I) + 1)
        rows[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    rows[0, :] = np.arange(L) % I  # a row with many items masked
    rows[1, :] = I                 # a row with none
    return u, items, rows


def _jax_masked(u, items, rows):
    return np.asarray(jax_k1.masked_scores(jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows),
                                           block_items=256, interpret=True))


def _emulated_masked(u, items, rows):
    I = items.shape[0]
    mask = k1.build_train_mask(torch.from_numpy(rows), k1._mask_width(I))[:, :I]
    scores = emulate_split(torch.from_numpy(u), torch.from_numpy(items))
    return torch.where(mask != 0, float("-inf"), scores).numpy()


@pytest.mark.parametrize("B,I,d,L,scale", [
    (16, 700, 32, 40, 1.0),
    (9, 1500, 16, 60, 1.0),
    (64, 1000, 64, 50, 1.0),
    (33, 513, 20, 30, 1.0),
    (64, 1000, 64, 50, 0.05),  # embedding-like magnitudes
])
def test_split_matches_jax_masked_scores(B, I, d, L, scale):
    u, items, rows = _inputs(B + d, B, I, d, L, scale)
    want = _jax_masked(u, items, rows)
    got = _emulated_masked(u, items, rows)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_at_d256_no_farther_from_f64_than_jax(seed):
    B, I, d = 96, 1100, 256
    u, items, rows = _inputs(seed, B, I, d, 40)
    want = _jax_masked(u, items, rows)
    got = _emulated_masked(u, items, rows)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    exact = u.astype(np.float64) @ items.astype(np.float64).T
    fin = np.isfinite(want)
    err_split = np.abs(got[fin] - exact[fin]).max()
    err_jax = np.abs(want[fin] - exact[fin]).max()
    assert err_split <= err_jax, (err_split, err_jax)


def test_split_at_d256_embedding_magnitudes_within_1e5():
    u, items, rows = _inputs(5, 64, 900, 256, 30, scale=0.05)
    want = _jax_masked(u, items, rows)
    got = _emulated_masked(u, items, rows)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_one_pass_tf32_misses_what_the_split_holds():
    """The split is needed: a one-pass TF32 product misses 1e-5 where the
    three-product split holds it."""
    u, items, _ = _inputs(7, 32, 400, 64, 1)
    tu, ti = torch.from_numpy(u), torch.from_numpy(items)
    want = u.astype(np.float64) @ items.astype(np.float64).T
    one_pass = (k1.round_tf32_reference(tu).double() @ k1.round_tf32_reference(ti).double().T).numpy()
    assert np.abs(one_pass - want).max() > 1e-3
    np.testing.assert_allclose(emulate_split(tu, ti).numpy(), want, rtol=1e-5, atol=1e-5)


class _Ops(TorchDispatchMode):
    """Records each aten op and the dtypes of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = [a for a in args if isinstance(a, torch.Tensor)]
        flat += [t for a in args if isinstance(a, (list, tuple)) for t in a if isinstance(t, torch.Tensor)]
        self.calls.append((str(func), [t.dtype for t in flat]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("I", [700, 1024])
def test_build_train_mask_takes_no_boolean_index(I):
    """No boolean-mask index (a host sync on the card) and the same bytes
    as the JAX package's, negative and far pad ids included."""
    _, _, rows = _inputs(3, 8, I, 8, 24)
    rows[:, -1] = -1
    rows[2, -2] = -I - 1
    rows[3, -2] = 2 ** 30
    with _Ops() as ops:
        got = k1.build_train_mask(torch.from_numpy(rows), I)
    for name, dtypes in ops.calls:
        assert "nonzero" not in name and "masked_select" not in name, name
        assert not (name.startswith("aten.index") and torch.bool in dtypes), (name, dtypes)
    assert got.is_contiguous() and got.shape == (8, I) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_k1.build_train_mask(jnp.asarray(rows), I)))
