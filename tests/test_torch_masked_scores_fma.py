"""K1's f32 path (d <= 40): what the wrapper decides in Python, and the
plain version of its arithmetic, on the CPU.

On the card the f32 path's scores are held bit for bit to the fmaf chain a
thread a score (``k1.fma_chain_scores``; tests/test_torch_cuda_kernels.py).
Here: the copy decision the wrapper passes (16-byte copies of a tile's rows
wherever both bases are 16-byte aligned, ragged d included), the chain's
plain version against the f64 product and against the JAX package's K1 in
interpret mode, and the CPU dispatch of the chain's entry point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import pallas_kernels as jax_k1
from neurec_tpu_torch.ops import masked_scores as k1

torch.set_float32_matmul_precision("highest")

F32_PATH_WIDTHS = [1, 2, 3, 16, 17, 21, 33, 40]


def _inputs(seed, B, I, d, L):
    rng = np.random.RandomState(seed)
    u = rng.randn(B, d).astype(np.float32)
    items = rng.randn(I, d).astype(np.float32)
    rows = np.full((B, L), I, dtype=np.int32)
    for b in range(B):
        n = rng.randint(0, min(L, I) + 1)
        rows[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    return u, items, rows


@pytest.mark.parametrize("d", F32_PATH_WIDTHS)
def test_f32_path_widths_take_16_byte_copies_wherever_aligned(d):
    """Every width of the f32 path, ragged d too, takes 16-byte copies when
    both bases are 16-byte aligned, and 4-byte copies when either is one
    float off (a view one float in, as a caller's slice gives)."""
    assert k1.k1_path(d) == "fma"
    u = torch.zeros(130, d)
    items = torch.zeros(300, d)
    assert k1.aligned16(u, items)
    u_off = torch.zeros(130 * d + 1)[1:].view(130, d)
    i_off = torch.zeros(300 * d + 1)[1:].view(300, d)
    assert u_off.is_contiguous() and u_off.contiguous().data_ptr() == u_off.data_ptr()
    assert not k1.aligned16(u_off, items)
    assert not k1.aligned16(u, i_off)
    assert not k1.aligned16(u_off, i_off)


def test_the_path_changes_at_d_41():
    assert [k1.k1_path(d) for d in (1, 40, 41, 64)] == ["fma", "fma", "split", "split"]


@pytest.mark.parametrize("d", F32_PATH_WIDTHS)
def test_fma_chain_reference_within_the_f32_bound_of_f64(d):
    """The chain's plain version is within d 2^-24 sum_k |u_k i_k| of the
    f64 product, the bound the card's f32 path is held to."""
    u, items, _ = _inputs(d, 20, 150, d, 1)
    got = k1.fma_chain_scores_reference(torch.from_numpy(u), torch.from_numpy(items)).double().numpy()
    exact = u.astype(np.float64) @ items.astype(np.float64).T
    bound = d * 2.0 ** -24 * (np.abs(u).astype(np.float64) @ np.abs(items).astype(np.float64).T)
    assert got.dtype == np.float64 and np.all(np.abs(got - exact) <= bound)


@pytest.mark.parametrize("d", [1, 17, 21, 33])
def test_fma_chain_with_the_mask_matches_jax_pallas_interpret(d):
    """The chain's plain version with K1's mask against the JAX package's
    K1 in interpret mode: -inf at the same places, the rest within 1e-5."""
    B, I, L = 12, 700, 40
    u, items, rows = _inputs(30 + d, B, I, d, L)
    want = np.asarray(jax_k1.masked_scores(jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows),
                                           block_items=256, interpret=True))
    chain = k1.fma_chain_scores(torch.from_numpy(u), torch.from_numpy(items))  # CPU dispatch
    mask = k1.build_train_mask(torch.from_numpy(rows), I) != 0
    got = torch.where(mask, float("-inf"), chain).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fma_chain_reference_rounds_each_step_once():
    """One fmaf rounds a*b + acc once: x*x - 1 for x = 1 + 2^-12 is 2^-11 +
    2^-24, where rounding x*x first (to 1 + 2^-11, a tie to even) loses the
    last term. Exact sums come out exact, and d = 0 gives zeros."""
    x = 1 + 2.0 ** -12
    got = k1.fma_chain_scores_reference(torch.tensor([[-1.0, x]]), torch.tensor([[1.0, x]]))
    assert float(got) == 2.0 ** -11 + 2.0 ** -24
    rng = np.random.RandomState(0)
    u = rng.randint(-8, 9, (7, 33)).astype(np.float32)
    items = rng.randint(-8, 9, (50, 33)).astype(np.float32)
    np.testing.assert_array_equal(k1.fma_chain_scores(torch.from_numpy(u), torch.from_numpy(items)).numpy(),
                                  u @ items.T)
    assert torch.equal(k1.fma_chain_scores(torch.zeros(3, 0), torch.zeros(5, 0)), torch.zeros(3, 5))


def test_fma_chain_rejects_what_k1_rejects():
    with pytest.raises(TypeError):
        k1.fma_chain_scores(torch.zeros(2, 4, dtype=torch.float64), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        k1.fma_chain_scores(torch.zeros(2, 4), torch.zeros(3, 5))
