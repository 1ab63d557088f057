"""The port's native host tier (``neurec_tpu_torch/native``) and the
evaluator's ``native`` backend, on the CPU.

* The eight cases of ``tests/test_native.py`` against the port's own copy:
  the build, the metrics against the numpy oracle (the port's
  ``ops/metrics_host.py``) and against the device evaluator, the sampler's
  exclusion and validation, ``arg_topk``, NaN ranked last, the empty
  catalogue.
* ``eval_score_matrix``, ``arg_topk`` and ``batch_randint_choice`` (the
  same seed) bit-equal to the JAX package's native library.
* ``UniEvaluator(backend="native")`` against the port's device backend and
  the JAX package's native backend: metric strings within 1e-6, on the
  full catalogue (with ties at the K-th place), on test negatives, and
  through ``GroupedEvaluator`` and ``Evaluator.from_dataset``.
* The library is built into ``build/neurec_tpu_torch/``, and a failed build
  raises (no fallback to the device backend).
"""

import os

import numpy as np
import pytest
import torch

from neurec_tpu_torch import native
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval.evaluator import Evaluator, GroupedEvaluator, UniEvaluator
from neurec_tpu_torch.ops.metrics_host import all_metrics_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ["Precision", "Recall", "MAP", "NDCG", "MRR"]


def test_builds():
    assert native.build().endswith(".so")


def test_eval_matches_numpy_oracle():
    rng = np.random.RandomState(0)
    B, I, K = 16, 100, 10
    scores = rng.randn(B, I).astype(np.float32)
    truth = [rng.choice(I, size=rng.randint(1, 10), replace=False).tolist() for _ in range(B)]
    got = native.eval_score_matrix(scores, truth, METRICS, K, n_threads=4)
    for b in range(B):
        order = np.argsort(-scores[b], kind="stable")[:K]
        want = all_metrics_host(order.tolist(), set(truth[b])).reshape(-1)
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-6)


def test_eval_matches_device_evaluator():
    rng = np.random.RandomState(1)
    num_users, num_items = 30, 80
    train, test = {}, {}
    for u in range(num_users):
        items = rng.choice(num_items, size=12, replace=False)
        train[u] = sorted(items[:9].tolist())
        test[u] = sorted(items[9:].tolist())
    scores = rng.randn(num_users, num_items).astype(np.float32)

    ev = UniEvaluator(train, test, metric=["Recall", "NDCG"], top_k=[5, 10], batch_size=16,
                      num_items=num_items, device="cpu")
    scores_t = torch.from_numpy(scores)
    device_result = ev.evaluate_raw(lambda p, u: scores_t[u], None)

    masked = scores.copy()
    for u in range(num_users):
        masked[u, train[u]] = -np.inf
    host = native.eval_score_matrix(masked, [test[u] for u in range(num_users)], ["Recall", "NDCG"], 10,
                                    n_threads=4)
    host_mean = host.mean(axis=0).reshape(2, 10)[:, [4, 9]]
    np.testing.assert_allclose(device_result, host_mean, rtol=1e-4, atol=1e-5)


def test_batch_randint_choice_exclusion():
    rng = np.random.RandomState(2)
    high = 50
    exclusion = [rng.choice(high, size=rng.randint(1, 30), replace=False).tolist() for _ in range(20)]
    counts = [rng.randint(1, 10) for _ in range(20)]
    out = native.batch_randint_choice(high, counts, exclusion, seed=7)
    assert len(out) == 20
    for draws, excl, c in zip(out, exclusion, counts):
        assert len(draws) == c
        assert not set(draws.tolist()) & set(excl)
        assert (draws >= 0).all() and (draws < high).all()


def test_arg_topk():
    rng = np.random.RandomState(3)
    scores = rng.randn(8, 40).astype(np.float32)
    got = native.arg_topk(scores, 5, n_threads=2)
    np.testing.assert_array_equal(got, np.argsort(-scores, axis=1, kind="stable")[:, :5])


def test_arg_topk_and_eval_rank_nan_last():
    scores = np.array([[1.0, np.nan, 3.0, 2.0], [np.nan, np.nan, 0.5, np.nan]], np.float32)
    idx = native.arg_topk(scores, k=4)
    np.testing.assert_array_equal(idx[0], [2, 3, 0, 1])
    assert idx[1][0] == 2
    np.testing.assert_array_equal(idx[1][1:], [0, 1, 3])  # NaNs after, the lowest index first
    out = native.eval_score_matrix(scores, [[2], [2]], ["Recall"], 4)
    assert np.all(np.isfinite(out))
    assert out[0, 1] == 1.0 and out[1, 0] == 1.0


def test_eval_empty_catalog_pads_zero():
    out = native.eval_score_matrix(np.zeros((2, 0), np.float32), [[], []], ["Recall", "NDCG"], 5)
    assert out.shape == (2, 10)
    np.testing.assert_array_equal(out, 0.0)


def test_batch_randint_choice_validates_like_reference():
    with pytest.raises(ValueError, match="not compatible"):
        native.batch_randint_choice(10, [2, 2, 2], [[1], [2]])
    with pytest.raises(ValueError, match="greater than 'high'"):
        native.batch_randint_choice(3, [1], [[0, 1, 2]])


# -- bit-equal to the JAX package's library ------------------------------------

@pytest.fixture(scope="module")
def jax_native():
    from neurec_tpu import native as jn

    jn.build()
    return jn


def _tied_scores(rng, B, I):
    """Scores on a coarse grid (ties at every place), some NaN and -inf."""
    s = (rng.randint(0, 12, (B, I)) / 4.0).astype(np.float32)
    s[rng.rand(B, I) < 0.05] = np.nan
    s[rng.rand(B, I) < 0.1] = -np.inf
    return s


def test_eval_score_matrix_is_bit_equal_to_jax(jax_native):
    rng = np.random.RandomState(4)
    B, I = 40, 300
    scores = _tied_scores(rng, B, I)
    truth = [rng.choice(I, size=rng.randint(1, 20), replace=False).tolist() for _ in range(B)]
    for K in (1, 10, 50, I + 3):
        got = native.eval_score_matrix(scores, truth, METRICS, K, n_threads=3)
        want = jax_native.eval_score_matrix(scores, truth, METRICS, K, n_threads=5)
        assert got.tobytes() == want.tobytes(), K


def test_arg_topk_is_bit_equal_to_jax(jax_native):
    rng = np.random.RandomState(5)
    scores = _tied_scores(rng, 33, 257)
    for k in (1, 20, 257, 260):
        np.testing.assert_array_equal(native.arg_topk(scores, k, n_threads=4), jax_native.arg_topk(scores, k))


def test_batch_randint_choice_is_bit_equal_to_jax(jax_native):
    rng = np.random.RandomState(6)
    high = 200
    exclusion = [rng.choice(high, size=rng.randint(0, 150), replace=False).tolist() for _ in range(25)]
    counts = [rng.randint(0, 30) for _ in range(25)]
    for seed in (0, 7, 2**40 + 3):
        got = native.batch_randint_choice(high, counts, exclusion, seed=seed)
        want = jax_native.batch_randint_choice(high, counts, exclusion, seed=seed)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


# -- the evaluator's native backend --------------------------------------------

def _dicts(seed, n_users=40, n_items=70, n_neg=None):
    rng = np.random.RandomState(seed)
    train, test, neg = {}, {}, {}
    for u in range(n_users):
        items = rng.choice(n_items, size=rng.randint(4, 16), replace=False).tolist()
        cut = max(1, int(0.7 * len(items)))
        train[u], test[u] = sorted(items[:cut]), sorted(items[cut:]) or [items[0]]
        if n_neg is not None:
            rest = [i for i in range(n_items) if i not in items]
            neg[u] = rng.choice(rest, size=n_neg, replace=False).tolist()
    scores = (rng.randint(0, 16, (n_users, n_items)) / 8.0).astype(np.float32)  # ties
    return train, test, (neg if n_neg is not None else None), scores


def _results(train, test, neg, scores, group_view=None, **kw):
    """Metric strings of the port's native and device backends and the JAX
    package's native backend."""
    import jax.numpy as jnp

    from neurec_tpu.eval.evaluator import Evaluator as JaxEvaluator

    s_t, s_j = torch.from_numpy(scores), jnp.asarray(scores)
    args = dict(metric=METRICS, top_k=[1, 5, 10], batch_size=16, num_items=scores.shape[1], group_view=group_view)
    port_native = Evaluator(train, test, neg, device="cpu", backend="native", num_thread=3, **args, **kw)
    port_device = Evaluator(train, test, neg, device="cpu", **args)
    jax_native = JaxEvaluator(train, test, neg, backend="native", num_thread=3, **args)
    return (port_native.evaluate(lambda p, u: s_t[u], None), port_device.evaluate(lambda p, u: s_t[u], None),
            jax_native.evaluate(lambda p, u: s_j[u], None))


def _assert_strings_close(a, b, atol=1e-6):
    la, lb = a.strip().split("\n"), b.strip().split("\n")
    assert len(la) == len(lb)
    for ra, rb in zip(la, lb):
        fa, fb = ra.split("\t"), rb.split("\t")
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            try:
                assert abs(float(x) - float(y)) <= atol, (ra, rb)
            except ValueError:
                assert x == y  # a group label
            assert len(x) == len(y)


@pytest.mark.parametrize("n_neg", [None, 9, 3])
def test_native_backend_matches_device_and_jax_native(n_neg):
    got, device, want = _results(*_dicts(7, n_neg=n_neg))
    _assert_strings_close(got, device)
    _assert_strings_close(got, want)
    assert len(got.split("\t")) == 15


def test_native_backend_grouped_matches(capsys):
    train, test, neg, scores = _dicts(8)
    got, device, want = _results(train, test, neg, scores, group_view=[4, 6, 20])
    assert "native (C++ host thread pool)" in capsys.readouterr().out
    ev = Evaluator(train, test, None, group_view=[4, 6, 20], device="cpu", backend="native", num_thread=3)
    assert isinstance(ev.evaluator, GroupedEvaluator)
    assert (ev.evaluator.evaluator.backend, ev.evaluator.evaluator.num_thread) == ("native", 3)
    assert got.count("\n") == 3 and got.startswith("\n(0,4]:")
    _assert_strings_close(got, device)
    _assert_strings_close(got, want)


def test_from_dataset_reads_backend_and_threads():
    ds = random_dataset(num_users=25, num_items=50, seed=2)
    conf = DictConfig({"topk": [5], "metric": ["Recall", "NDCG"], "eval_backend": "native", "num_thread": 2})
    ev = Evaluator.from_dataset(ds, conf, device="cpu").evaluator
    assert (ev.backend, ev.num_thread) == ("native", 2)
    dev = Evaluator.from_dataset(ds, DictConfig({"topk": [5], "metric": ["Recall", "NDCG"]}), device="cpu").evaluator
    assert (dev.backend, dev.num_thread) == ("device", 8)
    scores = torch.from_numpy(np.random.RandomState(0).randn(25, 50).astype(np.float32))
    _assert_strings_close(ev.evaluate(lambda p, u: scores[u], None), dev.evaluate(lambda p, u: scores[u], None))
    with pytest.raises(ValueError, match="eval_backend"):
        UniEvaluator({0: [1]}, {0: [2]}, device="cpu", backend="cpp")


def test_library_lands_in_the_build_directory():
    path = native.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "neurec_tpu_torch")
    assert os.path.basename(path).startswith("neurec_native-") and os.path.isfile(path)
    assert not [f for f in os.listdir(os.path.dirname(native.SOURCE)) if f.endswith(".so")]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    with pytest.raises(RuntimeError, match="build failed"):
        UniEvaluator({0: [1]}, {0: [2]}, device="cpu", backend="native")
    assert not os.path.exists(native.library_path())
    monkeypatch.setattr(native, "GXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="build failed"):
        native.build(force=True)
