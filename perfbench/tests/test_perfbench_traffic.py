"""The traffic and data the benchmark makes from its seeds."""

import numpy as np
import pytest
from scipy.sparse import csr_matrix

from perfbench import data
from perfbench.jobs.serve import Reservoir, edge_bucket, request_pool


def _train(degrees):
    rows = np.repeat(np.arange(len(degrees)), degrees)
    cols = np.concatenate([np.arange(d) for d in degrees])
    return csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(len(degrees), max(degrees) + 1))


def test_split_is_fixed_and_per_user(tmp_path):
    rng = np.random.RandomState(1)
    pairs = np.stack([rng.randint(0, 50, 2000), rng.randint(0, 300, 2000)], 1)
    pairs = np.unique(pairs, axis=0)
    a = data.split_ratio(pairs, 0.8, 2018)
    b = data.split_ratio(pairs[rng.permutation(len(pairs))], 0.8, 2018)
    n = np.bincount(np.unique(pairs[:, 0], return_inverse=True)[1].ravel())
    assert np.array_equal(np.diff(a.train.indptr), np.ceil(0.8 * n).astype(int))
    assert a.train.nnz + a.test.nnz == len(pairs)
    assert a.train.multiply(a.test).nnz == 0
    # the same pairs in another order: the same sizes
    assert np.array_equal(np.diff(a.train.indptr), np.diff(b.train.indptr))
    path = tmp_path / "r.rating"
    path.write_text("\n".join("%d,%d" % tuple(p) for p in pairs) + "\n")
    assert np.array_equal(data.read_pairs(str(path)), pairs)


def test_request_pool_is_seeded():
    train = _train([1, 5, 2, 9, 3, 7, 4, 4, 6, 1] * 5)
    a = request_pool(train, 10, 8, 123456789012)
    assert np.array_equal(a, request_pool(train, 10, 8, 123456789012))
    assert not np.array_equal(a, request_pool(train, 10, 8, 123456789013))
    for row in a:
        assert len(np.unique(row)) == 8  # without replacement


def test_requests_draw_users_by_degree():
    degrees = np.array([1, 2, 3, 4, 10])
    train = _train(degrees)
    first = request_pool(train, 20000, 1, 7)[:, 0]
    freq = np.bincount(first, minlength=5) / len(first)
    assert freq == pytest.approx(degrees / degrees.sum(), abs=0.01)


def test_edge_bucket_is_the_padded_largest_batch():
    train = _train([3, 3, 100, 1])
    assert edge_bucket(train, np.array([0, 1, 2, 3]), 2) == 128  # the batch (2, 3): 101 -> 128
    assert edge_bucket(train, np.array([0, 3]), 2) == 8


def test_reservoir_is_uniform_and_seeded():
    picks = np.zeros(20)
    for seed in range(2000):
        r = Reservoir(3, seed)
        for i in range(20):
            r.offer(i)
        picks[r.items] += 1
    assert picks / 2000 == pytest.approx(np.full(20, 3 / 20), abs=0.03)
    a, b = Reservoir(3, 5), Reservoir(3, 5)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items
