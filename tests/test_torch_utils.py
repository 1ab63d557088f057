"""The port's host utilities against the JAX package's, on the CPU:
``utils.py`` (``randint_choice``, ``typeassert``, ``inner_product``,
``argmax_top_k``), ``data/iterator.py`` (``DataIterator``) and
``ops/metrics_host.py``. The draws are numpy's global stream in both: the
same ``np.random.seed`` gives the same batches and samples."""

import numpy as np
import pytest

from neurec_tpu.data.iterator import DataIterator as JaxDataIterator
from neurec_tpu.ops import metrics_host as jax_metrics_host
from neurec_tpu.utils import argmax_top_k as jax_argmax_top_k
from neurec_tpu.utils import inner_product as jax_inner_product
from neurec_tpu.utils import randint_choice as jax_randint_choice
from neurec_tpu_torch.data.iterator import DataIterator
from neurec_tpu_torch.ops import metrics_host
from neurec_tpu_torch.utils import argmax_top_k, inner_product, randint_choice, typeassert


def _batches(cls, seed, *data, **kw):
    np.random.seed(seed)
    return [b if isinstance(b, tuple) else (b,) for b in cls(*data, **kw)]


@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=4, shuffle=True),
                                dict(batch_size=4, shuffle=True, drop_last=True), dict(batch_size=20)])
def test_data_iterator_batches_equal_jax(kw):
    users = np.arange(100, 117, dtype=np.int32)
    items = ["i%d" % i for i in range(17)]
    for data in ((users,), (users, items)):
        got = _batches(DataIterator, 3, *data, **kw)
        want = _batches(JaxDataIterator, 3, *data, **kw)
        assert got == want
        assert len(DataIterator(*data, **kw)) == len(JaxDataIterator(*data, **kw))


def test_data_iterator_basics():
    it = DataIterator([1, 2, 3, 4, 5], ["a", "b", "c", "d", "e"], batch_size=2)
    assert len(it) == 3
    assert list(it) == [([1, 2], ["a", "b"]), ([3, 4], ["c", "d"]), ([5], ["e"])]
    arr = np.arange(1000, dtype=np.int32)
    assert DataIterator(arr, batch_size=100)._data[0] is arr  # kept as given, not boxed
    with pytest.raises(ValueError, match="equal length"):
        DataIterator([1, 2], [1])
    with pytest.raises(ValueError, match="at least one"):
        DataIterator()


def test_data_iterator_pandas_series_positional():
    """A filtered Series indexes by label; the batches are positional, as
    in ``tests/test_utils.py::test_data_iterator_pandas_series_positional``."""
    import pandas as pd

    df = pd.DataFrame({"user": [10, 20, 30, 40, 50]})
    filtered = df[df["user"] > 20]["user"]  # labels 2, 3, 4
    assert [list(b) for b in DataIterator(filtered, batch_size=2)] == [[30, 40], [50]]
    assert [list(b) for b in DataIterator(filtered, batch_size=2)] == [
        list(b) for b in JaxDataIterator(filtered, batch_size=2)]


@pytest.mark.parametrize("kw", [dict(size=10), dict(size=10, exclusion=[0, 1, 2]),
                                dict(size=5, replace=False, exclusion=[3, 4]),
                                dict(size=6, p=np.linspace(1.0, 2.0, 20), exclusion=[7]), dict()])
def test_randint_choice_draws_equal_jax(kw):
    np.random.seed(11)
    got = [randint_choice(20, **kw) for _ in range(5)]
    np.random.seed(11)
    want = [jax_randint_choice(20, **kw) for _ in range(5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if "exclusion" in kw:
        assert not set(np.concatenate([np.atleast_1d(g) for g in got]).tolist()) & set(kw["exclusion"])


def test_typeassert():
    @typeassert(x=int, y=(str, None))
    def f(x, y=None):
        return x

    assert f(3) == 3 and f(3, "hi") == 3 and f(3, None) == 3
    with pytest.raises(TypeError, match="'x'"):
        f("no")
    with pytest.raises(TypeError, match="'y'"):
        f(3, 4.0)


def test_inner_product_and_argmax_top_k_equal_jax():
    rng = np.random.RandomState(4)
    a, b = rng.randn(7, 5), rng.randn(7, 5)
    np.testing.assert_array_equal(inner_product(a, b), jax_inner_product(a, b))
    np.testing.assert_array_equal(argmax_top_k(np.array([5.0, 1.0, 9.0, 9.0, 3.0]), 3), [2, 3, 0])
    for k in (1, 5, 30, 40):
        # ties (argpartition picks among those at the K-th place as numpy
        # does in both), then distinct values (the stable order)
        x = rng.randint(0, 6, 40).astype(np.float64)
        np.testing.assert_array_equal(argmax_top_k(x, k), jax_argmax_top_k(x, k))
        x = rng.permutation(40).astype(np.float64)
        np.testing.assert_array_equal(argmax_top_k(x, k), np.argsort(-x, kind="stable")[:k])


def test_metrics_host_equal_jax_on_random_ranks():
    rng = np.random.RandomState(5)
    for _ in range(50):
        K = rng.randint(1, 30)
        rank = rng.choice(60, K, replace=False).tolist()
        truth = set(rng.choice(60, rng.randint(1, 15), replace=False).tolist())
        got = metrics_host.all_metrics_host(rank, truth)
        assert got.shape == (5, K) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_metrics_host.all_metrics_host(rank, truth))
        for name in metrics_host.METRIC_FNS:
            np.testing.assert_array_equal(metrics_host.METRIC_FNS[name](rank, truth),
                                          jax_metrics_host.METRIC_FNS[name](rank, truth))


def test_metrics_host_is_the_oracle_of_the_device_metrics():
    """The port's ``ops/metrics.py`` against its own numpy oracle."""
    import torch

    from neurec_tpu_torch.ops.metrics import all_metrics, hit_matrix

    rng = np.random.RandomState(6)
    B, K, T = 12, 10, 6
    ranks = np.stack([rng.choice(40, K, replace=False) for _ in range(B)])
    lens = rng.randint(1, T + 1, B)
    truths = np.full((B, T), 40)
    for b in range(B):
        truths[b, : lens[b]] = rng.choice(40, lens[b], replace=False)
    got = all_metrics(hit_matrix(torch.from_numpy(ranks), torch.from_numpy(truths), torch.from_numpy(lens)),
                      torch.from_numpy(lens)).numpy()
    for b in range(B):
        want = metrics_host.all_metrics_host(ranks[b].tolist(), set(truths[b, : lens[b]].tolist()))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-7)
