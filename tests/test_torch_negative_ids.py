"""Negative item ids in padded train rows: the port against the JAX package.

JAX's ``.at[ids]`` wraps an id in [-n, 0) to ``id + n`` over the axis it
indexes and its scatters drop ids outside [-n, n). The port's mask builders
do the same over the same widths: ``build_train_mask`` over the items,
``pack_train_bits`` over the items rounded up to the block, K1's int8 mask
over the items rounded up to the JAX kernel's block of 512, and the
``scatter`` tier over the items and its dump column. The same numpy rows,
with -1, -2, -I and -I - 1 among the pads, go to both packages: the masks
must be equal byte for byte, the masked scores equal with -inf at the same
places (atol/rtol 1e-5: both in f32, another summation order), and the
top-K ids of the ``bits``, ``pallas`` and ``scatter`` tiers identical.
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
K = 20


def _inputs(seed, B, I, d, L):
    """Factors on a grid of 1/4 (exact scores, so exact ties) and train
    rows padded with I, with negative ids in the last slots."""
    rng = np.random.RandomState(seed)
    u = np.round(rng.randn(B, d) * 4).astype(np.float32) / 4
    items = np.round(rng.randn(I, d) * 4).astype(np.float32) / 4
    rows = np.full((B, L), I, dtype=np.int32)
    for b in range(B):
        n = rng.randint(0, L - 3)
        rows[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    rows[:, -1] = -1
    rows[1::2, -2] = -2
    rows[2, -3] = -I      # the lowest id that wraps: item 0
    rows[3, -3] = -I - 1  # below -I: dropped
    return u, items, rows


# I = 700 wraps -1 into the pad columns of the padded widths and into the
# last item of the unpadded ones; I = 1024 is a multiple of every block
SIZES = [(700, 8), (1024, 16)]


@pytest.mark.parametrize("I,d", SIZES)
def test_train_masks_wrap_negative_ids_as_jax(I, d):
    _, _, rows = _inputs(0, 8, I, d, 24)
    t_rows = torch.from_numpy(rows)
    got = k1.build_train_mask(t_rows, I).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_k1.build_train_mask(jnp.asarray(rows), I)))
    assert got[:, I - 1].all() and got[1::2, I - 2].all() and got[2, 0]  # wrapped, not dropped
    for block in (256, 1024, tiers.global_bits_width(I)):
        np.testing.assert_array_equal(
            k1.pack_train_bits(t_rows, I, block_items=block).numpy(),
            np.asarray(jax_k1.pack_train_bits(jnp.asarray(rows), I, block_items=block)),
        )


@pytest.mark.parametrize("I,d", SIZES)
def test_masked_scores_wrap_negative_ids_as_jax(I, d):
    u, items, rows = _inputs(1, 8, I, d, 24)
    want = np.asarray(jax_k1.masked_scores(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows), interpret=True))
    for fn in (k1.masked_scores_reference, k1.masked_scores):  # CPU dispatch
        got = fn(torch.from_numpy(u), torch.from_numpy(items), torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("I,d", SIZES)
def test_tier_topk_ids_wrap_negative_ids_as_jax(I, d):
    u, items, rows = _inputs(2, 8, I, d, 24)
    tu, titems, trows = (torch.from_numpy(a) for a in (u, items, rows))
    width = tiers.global_bits_width(I)
    bits_j = jax_k1.pack_train_bits(jnp.asarray(rows), I, block_items=width)
    ids_j = np.asarray(jax_tiers.make_bits_topk(K, width, I)(jnp.asarray(u), jnp.asarray(items), bits_j))
    ids = tiers.make_bits_topk(K, width, I)(tu, titems, k1.pack_train_bits(trows, I, block_items=width))
    np.testing.assert_array_equal(ids.numpy(), ids_j)

    ids_j = np.asarray(jax_tiers.make_pallas_topk(K, interpret=True)(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows)))
    np.testing.assert_array_equal(tiers.make_pallas_topk(K)(tu, titems, trows).numpy(), ids_j)

    scores = u @ items.T
    scores[:, I - 1] = 100.0  # the last item first for every user, unless masked
    ids_j = np.asarray(jax_tiers.make_scatter_topk(K, I)(jnp.asarray(scores), jnp.asarray(rows)))
    ids = tiers.make_scatter_topk(K, I)(torch.from_numpy(scores), trows).numpy()
    np.testing.assert_array_equal(ids, ids_j)
    # over the I + 1 columns -1 wraps to the dump column and -2 to the last item
    assert (ids[0::2, 0] == I - 1).all() and not (ids[1::2] == I - 1).any()
