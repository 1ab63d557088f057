"""K1 (fused score + train mask) in the port against the JAX package.

The mask builders must give identical bytes; the plain versions must match
JAX's Pallas kernel (interpret mode) and the bits tier's masked scores to
rtol/atol 1e-5 with -inf at identical places. The CUDA kernel itself is
held to its plain version on a card in test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.eval import tiers as jax_tiers
from neurec_tpu.ops import pallas_kernels as jax_k1
from neurec_tpu_torch.eval import tiers
from neurec_tpu_torch.ops import masked_scores as k1

torch.set_float32_matmul_precision("highest")


def _inputs(seed, B, I, d, L, pad=None, dup=0):
    rng = np.random.RandomState(seed)
    u = rng.randn(B, d).astype(np.float32)
    items = rng.randn(I, d).astype(np.float32)
    for j in range(dup):  # exact ties: duplicated item rows
        items[I - 1 - j] = items[j]
    pad = I if pad is None else pad
    rows = np.full((B, L), pad, dtype=np.int32)
    for b in range(B):
        n = rng.randint(0, min(L, I) + 1)
        rows[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    rows[0, -1] = 2 ** 30  # a far pad id is dropped too
    return u, items, rows


CASES = [  # (B, I, d, L): ragged I, pad ids >= I, L >= 1024
    (16, 700, 32, 40),
    (9, 1500, 16, 1200),
    (5, 1024, 8, 3),
]


@pytest.mark.parametrize("B,I,d,L", CASES)
def test_mask_builders_bytes_identical(B, I, d, L):
    _, _, rows = _inputs(0, B, I, d, L)
    t_rows = torch.from_numpy(rows)
    np.testing.assert_array_equal(
        k1.build_train_mask(t_rows, I).numpy(),
        np.asarray(jax_k1.build_train_mask(jnp.asarray(rows), I)),
    )
    for block in (256, 1024, tiers.global_bits_width(I)):
        want = np.asarray(jax_k1.pack_train_bits(jnp.asarray(rows), I, block_items=block))
        got = k1.pack_train_bits(t_rows, I, block_items=block).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        I_p = I + (-I) % block
        mask = np.array(jax_k1.build_train_mask(jnp.asarray(rows), I_p))
        np.testing.assert_array_equal(
            k1.pack_mask_bits(torch.from_numpy(mask), block).numpy(),
            np.asarray(jax_k1.pack_mask_bits(jnp.asarray(mask), block)),
        )


@pytest.mark.parametrize("B,I,d,L", CASES)
def test_masked_scores_matches_jax_pallas_interpret(B, I, d, L):
    u, items, rows = _inputs(1, B, I, d, L)
    want = np.asarray(jax_k1.masked_scores(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows),
        block_items=256, interpret=True,
    ))
    for fn in (k1.masked_scores_reference, k1.masked_scores):  # CPU dispatch
        got = fn(torch.from_numpy(u), torch.from_numpy(items), torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_bits_masked(u, items, bits, width, I):
    items_p = np.pad(items, ((0, width - I), (0, 0)))
    scores = jnp.dot(jnp.asarray(u), jnp.asarray(items_p).T)
    return np.asarray(jnp.where(jax_tiers.bits_expand(bits, width) != 0, -jnp.inf, scores)[:, :I])


@pytest.mark.parametrize("B,I,d,L", CASES)
def test_masked_scores_bits_matches_jax_bits_tier(B, I, d, L):
    u, items, rows = _inputs(2, B, I, d, L, dup=5)
    width = tiers.global_bits_width(I)
    bits_j = jax_k1.pack_train_bits(jnp.asarray(rows), I, block_items=width)
    bits = torch.from_numpy(np.array(bits_j))
    want = _jax_bits_masked(u, items, bits_j, width, I)
    for fn in (k1.masked_scores_bits_reference, k1.masked_scores_bits):
        got = fn(torch.from_numpy(u), torch.from_numpy(items), bits, width, I).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the tier's top-K: same ids, exact ties (duplicated rows) lowest id first
    K = 20
    ids_j = np.asarray(jax_tiers.make_bits_topk(K, width, I)(
        jnp.asarray(u), jnp.asarray(items), bits_j))
    ids = tiers.make_bits_topk(K, width, I)(torch.from_numpy(u), torch.from_numpy(items), bits).numpy()
    np.testing.assert_array_equal(ids, ids_j)


def test_pallas_and_scatter_tiers_match_jax():
    B, I, d, L = 12, 300, 8, 30
    u, items, rows = _inputs(3, B, I, d, L, dup=20)
    u = np.round(u * 4) / 4  # exactly representable scores: exact ties
    items = np.round(items * 4) / 4
    K = 25
    ids_j = np.asarray(jax_tiers.make_pallas_topk(K, interpret=True)(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows)))
    ids = tiers.make_pallas_topk(K)(torch.from_numpy(u), torch.from_numpy(items),
                                    torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(ids, ids_j)
    scores = u @ items.T
    ids_j = np.asarray(jax_tiers.make_scatter_topk(K, I)(jnp.asarray(scores), jnp.asarray(rows)))
    ids = tiers.make_scatter_topk(K, I)(torch.from_numpy(scores), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(ids, ids_j)


def test_wrappers_reject_bad_inputs():
    u = torch.zeros(4, 8)
    items = torch.zeros(10, 8)
    with pytest.raises(TypeError):
        k1.masked_scores(u.double(), items, torch.zeros(4, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        k1.masked_scores_bits(u, items, torch.zeros(4, 3, dtype=torch.uint8), 1024, 10)
    with pytest.raises(ValueError):
        k1.masked_scores_bits(u, items, torch.zeros(4, 128, dtype=torch.uint8), 1024, 11)
