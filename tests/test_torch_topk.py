"""``ops/topk.py::top_k`` against ``jax.lax.top_k``, values and ids, on the
CPU: the same numpy rows through both, compared exactly (ids equal, values
equal bit for bit). Rows with ties across the K-th place, rows of equal
values, all -inf rows, NaN of either sign and signed zeros (``lax.top_k``
orders by the IEEE total order), k = 1 and k = I. The port's answer needs
no host sync: under ``torch.cuda`` it is built from ``torch.topk``,
comparisons, ``where``, ``gather`` and two sorts of K (the card case is
in test_torch_cuda_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu_torch.ops.topk import order_key, top_k


def _check(x, k):
    vj, ij = jax.lax.top_k(jnp.asarray(x), k)
    v, i = top_k(torch.from_numpy(x), k)
    assert i.dtype == torch.int64 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(v.numpy().view(np.int32), np.asarray(vj).view(np.int32))


def _neg_nan():
    return (np.array([np.nan], np.float32).view(np.uint32) | np.uint32(0x80000000)).view(np.float32)[0]


@pytest.mark.parametrize("k", [1, 5, 20, 57])
def test_ties_across_the_kth_place(k):
    rng = np.random.RandomState(k)
    x = rng.randint(-4, 5, (12, 57)).astype(np.float32)  # many ties at every place
    _check(x, k)


@pytest.mark.parametrize("k", [1, 3, 40])
def test_rows_of_equal_values_and_all_minus_inf(k):
    x = np.zeros((4, 40), np.float32)
    x[1] = 7.5
    x[2] = -np.inf
    x[3, :] = -np.inf
    x[3, [5, 30]] = 1.0  # two finite entries, the rest tied at -inf
    _check(x, k)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_nans_and_signed_zeros_follow_the_total_order(k):
    x = np.array([[0.0, -0.0, 1.0, np.nan, -np.inf, _neg_nan(), -0.0, np.nan, 0.0],
                  [-0.0, -0.0, -0.0, 0.0, -1.0, -0.0, 0.0, -np.inf, _neg_nan()]], np.float32)
    _check(x, k)


@pytest.mark.parametrize("seed", range(6))
def test_random_rows_with_masked_items(seed):
    """Scores as the evaluator ranks them: random values, a share of -inf
    train items, and a forced tie across the 20th place."""
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 300).astype(np.float32)
    x[rng.rand(16, 300) < 0.1] = -np.inf
    order = np.argsort(-x[0])
    x[0, order[15:30]] = x[0, order[19]]
    _check(x, 20)
    _check(x, 300)


def test_order_key_is_the_total_order():
    vals = np.array([_neg_nan(), -np.inf, -3.0, -1e-38, -0.0, 0.0, 1e-45, 2.0, np.inf, np.nan], np.float32)
    keys = order_key(torch.from_numpy(vals)).numpy()
    assert (np.diff(keys.astype(np.int64)) > 0).all()


def test_leading_axes_and_bf16_scores():
    rng = np.random.RandomState(9)
    x = rng.randint(0, 3, (2, 3, 17)).astype(np.float32)
    v, i = top_k(torch.from_numpy(x), 6)
    for a in range(2):
        vj, ij = jax.lax.top_k(jnp.asarray(x[a]), 6)
        np.testing.assert_array_equal(i[a].numpy(), np.asarray(ij))
        np.testing.assert_array_equal(v[a].numpy(), np.asarray(vj))
    xb = torch.from_numpy(x[0]).bfloat16()
    vb, ib = top_k(xb, 6)
    assert vb.dtype == torch.bfloat16
    np.testing.assert_array_equal(ib.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x[0]), 6)[1]))
