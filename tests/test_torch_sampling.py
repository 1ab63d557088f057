"""The port's padded exclusion table and negative sampler against the JAX
package's.

``build_padded_positives`` and ``is_positive`` must be identical. The
sampler draws from torch's generator, not JAX's, so it is held to the
JAX package's statistical contract (tests/test_sampling.py, redone here):
no positive is ever returned, every id lies in [0, num_items), and the
draws over a user's complement are uniform to the same bounds. The same
generator seed gives the same draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu.data.padded import build_padded_positives as jax_build_padded
from neurec_tpu.ops.sampling import is_positive as jax_is_positive
from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.ops.sampling import is_positive, sample_negatives, sample_negatives_flat


def _padded_rows(pos_lists, num_items):
    L = max(len(p) for p in pos_lists)
    rows = np.full((len(pos_lists), L), num_items, dtype=np.int32)
    for i, p in enumerate(pos_lists):
        rows[i, : len(p)] = np.sort(p)
    return rows


@pytest.mark.parametrize("n_users,n_items,density", [(50, 80, 0.1), (7, 300, 0.02), (20, 10, 0.6), (3, 5, 0.0)])
def test_build_padded_positives_identical(n_users, n_items, density):
    m = sp.random(n_users, n_items, density=density, random_state=np.random.RandomState(0), format="csr")
    m.data[:] = 1.0
    got, want = build_padded_positives(m), jax_build_padded(m)
    for name in ("items", "lengths"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_items == want.num_items and got.max_len == want.max_len
    assert got.max_len % 8 == 0 and got.max_len >= 8


def test_is_positive_identical():
    rng = np.random.RandomState(1)
    num_items = 40
    rows = _padded_rows([rng.choice(num_items, rng.randint(1, 15), replace=False) for _ in range(30)], num_items)
    cands = rng.randint(0, num_items, (30, 6, 2)).astype(np.int32)
    got = is_positive(torch.from_numpy(rows), torch.from_numpy(cands)).numpy()
    want = np.asarray(jax_is_positive(jnp.asarray(rows), jnp.asarray(cands)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4,), ()])
def test_exclusion_correctness(shape):
    rng = np.random.RandomState(0)
    num_items = 100
    pos_lists = [rng.choice(num_items, size=rng.randint(1, 60), replace=False).tolist() for _ in range(50)]
    rows = torch.from_numpy(_padded_rows(pos_lists, num_items))
    gen = torch.Generator().manual_seed(0)
    for trial in range(20):
        negs = sample_negatives(gen, rows, num_items, shape, num_rounds=32).numpy()
        assert negs.shape == (50,) + shape and negs.dtype == np.int32
        for i, pos in enumerate(pos_lists):
            assert not set(negs[i].reshape(-1).tolist()) & set(pos), "trial %d row %d sampled a positive" % (trial, i)
            assert (negs[i] >= 0).all() and (negs[i] < num_items).all()


def test_uniformity_over_non_positives():
    num_items = 50
    rows = torch.from_numpy(_padded_rows([list(range(25))], num_items))  # half the catalogue excluded
    gen = torch.Generator().manual_seed(42)
    counts = np.zeros(num_items)
    for _ in range(200):
        np.add.at(counts, sample_negatives(gen, rows, num_items, (64,)).numpy().reshape(-1), 1)
    assert counts[:25].sum() == 0
    freq = counts[25:] / counts.sum()
    assert freq.max() < 0.08 and freq.min() > 0.015  # 1/25 = 0.04 each


def test_all_rounds_colliding_fall_back_to_round_zero():
    num_items = 4
    rows = torch.from_numpy(_padded_rows([[0, 1, 2, 3]], num_items))  # no negative exists
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    negs = sample_negatives(gen, rows, num_items, (5,), num_rounds=3)
    gen.set_state(state)
    draws = torch.randint(0, num_items, (1, 3, 5), generator=gen, dtype=torch.int32)
    assert torch.equal(negs, draws[:, 0])


def test_same_seed_same_draws_and_flat_batch():
    num_items = 30
    pos_lists = [[0, 1, 2], [10, 11], [29]]
    table = torch.from_numpy(_padded_rows(pos_lists, num_items))
    user_ids = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int32)
    a = sample_negatives_flat(torch.Generator().manual_seed(7), user_ids, table, num_items)
    b = sample_negatives_flat(torch.Generator().manual_seed(7), user_ids, table, num_items)
    c = sample_negatives_flat(torch.Generator().manual_seed(8), user_ids, table, num_items, shape=(50,))
    assert a.shape == (6,) and torch.equal(a, b)
    for uid, n in zip(user_ids.tolist(), a.tolist()):
        assert n not in pos_lists[uid]
    assert c.shape == (6, 50) and not torch.equal(c[:, 0], a)
