"""The sampled-candidates protocol (test negatives) against the JAX
package's, on the CPU.

* A shipped ``<name>.neg`` with numeric ids, then text ids, then an
  all-numeric column of text-keyed items, is remapped as the JAX package
  remaps it: the same ``.neg<N>`` cache file, byte for byte, and the same
  ``negative_matrix``.
* A ragged line raises ``ValueError`` in both; an empty or
  whitespace-only ``.neg`` raises ``ValueError`` in both (pandas'
  ``EmptyDataError`` in the JAX package), the port's naming the dataset.
* ``rec.evaluate.neg = N``: the generated ``.neg<N>`` is byte-equal to the
  JAX package's, and read back from the cache on the next load.
* The candidate evaluation: metric strings to 1e-6 against the JAX
  evaluator, on scores with ties at the K-th place and with fewer
  candidates than K, for a factorized model, a ``predict`` model and a
  model with ``eval_dense_scores``; also grouped.
* ``run.main`` trains MF and evaluates it on the test negatives.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.config import Config as JaxConfig
from neurec_tpu.data.dataset import Dataset as JaxDataset
from neurec_tpu.eval.evaluator import Evaluator as JaxEvaluator
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.eval.evaluator import Evaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "NeuRec.properties")


def write_ratings(root, str_ids=False, n_users=30, n_items=40, seed=0, str_items=None):
    rng = np.random.RandomState(seed)
    str_items = str_ids if str_items is None else str_items
    uid = (lambda u: "u%d" % (u + 100)) if str_ids else (lambda u: str(u + 100))
    iid = (lambda i: "i%d" % (i + 7)) if str_items else (lambda i: str(i + 7))
    rated = {}
    with open(os.path.join(root, "neg.rating"), "w") as f:
        for u in range(n_users):
            rated[u] = rng.choice(n_items, rng.randint(5, 12), replace=False)
            for i in rated[u]:
                f.write("%s,%s,%d\n" % (uid(u), iid(i), rng.randint(1, 6)))
    return rated, uid, iid


def load_both(root, neg=0, extra=()):
    def args(cache):
        return ["--recommender=MF", "--config_dir=%s" % os.path.join(REPO, "conf"),
                "--data.input.path=%s" % root, "--data.cache.path=%s" % os.path.join(root, cache),
                "--data.input.dataset=neg", "--data.column.format=UIR", "--data.convert.separator=','",
                "--splitter=ratio", "--ratio=0.8", "--by_time=False", "--user_min=0", "--item_min=0",
                "--rec.evaluate.neg=%d" % neg] + list(extra)

    conf_j, conf = JaxConfig(LIB, cmd_args=args("jax")), Config(LIB, cmd_args=args("port"))
    return JaxDataset(conf_j), Dataset(conf), conf_j, conf


def cache_file(root, which, suffix):
    d = os.path.join(root, which, "_tmp_neg")
    names = [f for f in os.listdir(d) if f.endswith(suffix)]
    assert len(names) == 1, names
    with open(os.path.join(d, names[0]), "rb") as f:
        return f.read()


def same_csr(a, b):
    assert a.shape == b.shape and (a != b).nnz == 0
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("ids", ["numeric", "text", "text-users-numeric-items"])
def test_shipped_neg_file_is_remapped_as_jax_does(tmp_path, ids):
    root = str(tmp_path)
    rated, uid, iid = write_ratings(root, str_ids=ids != "numeric", str_items=ids == "text")
    rng = np.random.RandomState(1)
    lines = []
    for u, items in rated.items():
        free = [i for i in range(40) if i not in set(items)]
        lines.append("%s,%s" % (uid(u), ",".join(iid(i) for i in rng.choice(free, 3, replace=False))))
    with open(os.path.join(root, "neg.neg"), "w") as f:
        f.write("\n".join(lines) + "\n")
    ds_j, ds, _, _ = load_both(root, neg=3)
    assert cache_file(root, "jax", ".neg3") == cache_file(root, "port", ".neg3")
    same_csr(ds.negative_matrix, ds_j.negative_matrix)
    assert ds.get_user_test_neg_dict() == ds_j.get_user_test_neg_dict()
    assert all(len(v) == 3 for v in ds.get_user_test_neg_dict().values())


def test_shipped_neg_file_with_numeric_tokens_for_text_keys(tmp_path):
    """Items with text and digit ids in the rating file (a text column, so
    the map is keyed by text) and a .neg of digit tokens only (an int
    column): ``_remap_token`` finds each token as text."""
    root = str(tmp_path)
    rng = np.random.RandomState(2)
    name = lambda i: "x%d" % i if i % 5 == 0 else str(i)  # noqa: E731
    rated = {}
    with open(os.path.join(root, "neg.rating"), "w") as f:
        for u in range(30):
            rated[u] = set(rng.choice(30, 6, replace=False).tolist()) | {u}
            f.write("".join("u%d,%s,1\n" % (u, name(i)) for i in sorted(rated[u])))
    digits = [i for i in range(30) if i % 5]
    with open(os.path.join(root, "neg.neg"), "w") as f:
        f.write("".join("u%d,%s\n" % (u, ",".join(str(i) for i in rng.choice(
            [i for i in digits if i not in rated[u]], 2, replace=False))) for u in range(30)))
    ds_j, ds, _, _ = load_both(root, neg=2)
    assert isinstance(next(iter(ds.itemids)), str)
    assert cache_file(root, "jax", ".neg2") == cache_file(root, "port", ".neg2")
    same_csr(ds.negative_matrix, ds_j.negative_matrix)


@pytest.mark.parametrize("content", ["", "   \n\n", "\n"], ids=["empty", "whitespace", "blank-line"])
def test_empty_neg_file_raises_value_error_in_both(tmp_path, content):
    root = str(tmp_path)
    write_ratings(root)
    with open(os.path.join(root, "neg.neg"), "w") as f:
        f.write(content)
    args = ["--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % root,
            "--data.input.dataset=neg", "--data.column.format=UIR", "--data.convert.separator=','",
            "--user_min=0", "--item_min=0"]
    with pytest.raises(ValueError):
        JaxDataset(JaxConfig(LIB, cmd_args=args + ["--data.cache.path=%s" % os.path.join(root, "jax")]))
    with pytest.raises(ValueError, match="neg.neg is empty"):
        Dataset(Config(LIB, cmd_args=args + ["--data.cache.path=%s" % os.path.join(root, "port")]))


@pytest.mark.parametrize("ragged", ["short", "long"])
def test_ragged_neg_line_raises_in_both(tmp_path, ragged):
    root = str(tmp_path)
    write_ratings(root)
    rows = ["100,9,10,11", "101,12,13" if ragged == "short" else "101,12,13,14,15", "102,9,10,11"]
    with open(os.path.join(root, "neg.neg"), "w") as f:
        f.write("\n".join(rows) + "\n")
    args = ["--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % root,
            "--data.input.dataset=neg", "--data.column.format=UIR", "--data.convert.separator=','",
            "--user_min=0", "--item_min=0", "--rec.evaluate.neg=3"]
    with pytest.raises(ValueError):
        JaxDataset(JaxConfig(LIB, cmd_args=args + ["--data.cache.path=%s" % os.path.join(root, "jax")]))
    with pytest.raises(ValueError, match="ragged"):
        Dataset(Config(LIB, cmd_args=args + ["--data.cache.path=%s" % os.path.join(root, "port")]))


@pytest.mark.parametrize("n_neg", [5, 17])
def test_generated_negatives_are_byte_equal_to_jax(tmp_path, n_neg):
    root = str(tmp_path)
    write_ratings(root)
    ds_j, ds, conf_j, conf = load_both(root, neg=n_neg)
    assert cache_file(root, "jax", ".neg%d" % n_neg) == cache_file(root, "port", ".neg%d" % n_neg)
    same_csr(ds.negative_matrix, ds_j.negative_matrix)
    neg = ds.get_user_test_neg_dict()
    train, test = ds.get_user_train_dict(), ds.get_user_test_dict()
    for u, negs in neg.items():
        assert len(negs) == n_neg and not set(negs) & (set(train.get(u, ())) | set(test.get(u, ())))
    # read back from the cache on the next load
    again = Dataset(conf)
    same_csr(again.negative_matrix, ds.negative_matrix)


class TinyMF:
    def predict(self, p, users):
        return p["u"][users] @ p["q"].T

    def eval_embeddings(self, p, users):
        return p["u"][users], p["q"]


class TinyPredict:
    def predict(self, p, users):
        return p["u"][users] @ p["q"].T


class TinyDense(TinyPredict):
    calls = 0

    def eval_dense_scores(self, p):
        TinyDense.calls += 1
        return p["u"] @ p["q"].T


@pytest.mark.parametrize("kind", ["factorized", "predict", "dense"])
@pytest.mark.parametrize("n_neg", [30, 3])
def test_candidate_metrics_match_jax(tmp_path, kind, n_neg):
    root = str(tmp_path)
    write_ratings(root, n_users=60, n_items=50)
    ds_j, ds, conf_j, conf = load_both(root, neg=n_neg, extra=["--topk=[5, 10]", "--test_batch_size=16"])
    rng = np.random.RandomState(3)
    # scores rounded to 0.25: many ties, some at the K-th place
    u = np.round(rng.randn(ds.num_users, 4) * 2) / 2
    q = np.round(rng.randn(ds.num_items, 4) * 2) / 2
    params_np = {"u": u.astype(np.float32), "q": q.astype(np.float32)}
    cls = {"factorized": TinyMF, "predict": TinyPredict, "dense": TinyDense}[kind]
    model = cls()
    ev_j = JaxEvaluator.from_dataset(ds_j, conf_j)
    ev = Evaluator.from_dataset(ds, conf, device="cpu")
    assert ev.evaluator._cand_rows is not None
    assert ev.evaluator._cand_rows.shape[1] >= 10
    want = ev_j.evaluate(model.predict, {k: jnp.asarray(v) for k, v in params_np.items()})
    TinyDense.calls = 0
    got = ev.evaluate(model.predict, {k: torch.from_numpy(v) for k, v in params_np.items()})
    assert (TinyDense.calls == 1) == (kind == "dense")
    assert len(got.split("\t")) == len(want.split("\t")) == 10
    np.testing.assert_allclose([float(x) for x in got.split("\t")], [float(x) for x in want.split("\t")],
                               atol=1e-6)
    assert ev.evaluator._bits_tables == {}
    assert ev.evaluator._get_program(model.predict).plan.name == "scatter"


def test_grouped_candidate_evaluation_matches_jax(tmp_path):
    root = str(tmp_path)
    write_ratings(root, n_users=60, n_items=50)
    ds_j, ds, conf_j, conf = load_both(root, neg=20, extra=["--group_view=[6, 9, 20]", "--topk=[5]"])
    rng = np.random.RandomState(4)
    params_np = {"u": rng.randn(ds.num_users, 4).astype(np.float32), "q": rng.randn(ds.num_items, 4).astype(np.float32)}
    model = TinyMF()
    want = JaxEvaluator.from_dataset(ds_j, conf_j).evaluate(model.predict,
                                                             {k: jnp.asarray(v) for k, v in params_np.items()})
    got = Evaluator.from_dataset(ds, conf, device="cpu").evaluate(model.predict,
                                                                  {k: torch.from_numpy(v) for k, v in params_np.items()})
    assert [ln.split("\t")[0] for ln in got.strip().split("\n")] == [ln.split("\t")[0]
                                                                     for ln in want.strip().split("\n")]
    np.testing.assert_allclose([float(x) for ln in got.strip().split("\n") for x in ln.split("\t")[1:]],
                               [float(x) for ln in want.strip().split("\n") for x in ln.split("\t")[1:]], atol=1e-6)


def test_run_main_with_test_negatives(tmp_path, monkeypatch):
    from neurec_tpu_torch import run

    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    os.makedirs(root)
    write_ratings(root, n_users=40, n_items=60)
    args = ["--recommender=MF", "--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % root,
            "--data.cache.path=%s" % os.path.join(root, "cache"), "--data.input.dataset=neg",
            "--data.column.format=UIR", "--data.convert.separator=','", "--rec.evaluate.neg=20", "--epochs=2",
            "--embedding_size=8", "--batch_size=64", "--topk=[5]", "--metric=[\"Recall\",\"NDCG\"]"]
    trainer, result = run.main(LIB, args, device="cpu")
    assert trainer.evaluator.evaluator.user_neg_test is not None
    values = [float(x) for x in result.split("\t")]
    assert len(values) == 2 and all(0.0 <= v <= 1.0 for v in values)
    assert any(f.endswith(".neg20") for f in os.listdir(os.path.join(root, "cache", "_tmp_neg")))
