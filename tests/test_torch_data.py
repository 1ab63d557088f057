"""The port's numpy data pipeline against the JAX package's pandas one:
identical split, id maps, matrices, cache files and summary string."""

import os

import numpy as np
import pytest

from neurec_tpu.config import Config as JaxConfig
from neurec_tpu.data.dataset import Dataset as JaxDataset
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "NeuRec.properties")


def _same_csr(a, b):
    assert a.shape == b.shape
    assert a.dtype == b.dtype
    assert (a != b).nnz == 0
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def _assert_same(jax_ds, port_ds):
    _same_csr(jax_ds.train_matrix, port_ds.train_matrix)
    _same_csr(jax_ds.test_matrix, port_ds.test_matrix)
    if jax_ds.time_matrix is None:
        assert port_ds.time_matrix is None
    else:
        _same_csr(jax_ds.time_matrix, port_ds.time_matrix)
    assert jax_ds.userids == port_ds.userids
    assert jax_ds.itemids == port_ds.itemids
    assert str(jax_ds) == str(port_ds)
    assert jax_ds.get_user_train_dict() == port_ds.get_user_train_dict()
    assert jax_ds.get_user_test_dict() == port_ds.get_user_test_dict()


def _cache_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fin:
                out[f] = fin.read()
    return out


def _args(data_path, cache, name, fmt, sep, splitter, by_time):
    return [
        "--recommender=LightGCN",
        "--config_dir=%s" % os.path.join(REPO, "conf"),
        "--data.input.path=%s" % data_path,
        "--data.cache.path=%s" % cache,
        "--data.input.dataset=%s" % name,
        "--data.column.format=%s" % fmt,
        "--data.convert.separator=%s" % sep,
        "--splitter=%s" % splitter,
        "--ratio=0.8",
        "--by_time=%s" % by_time,
    ]


def _both(tmp_path, *args):
    """Build each package's Dataset twice (fresh split, then from its
    cache) into separate cache roots; check every pairing."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_args = _args(args[0], str(jax_root), *args[1:])
    port_args = _args(args[0], str(port_root), *args[1:])
    fresh = JaxDataset(JaxConfig(LIB, cmd_args=jax_args)), Dataset(Config(LIB, cmd_args=port_args))
    _assert_same(*fresh)
    assert _cache_files(jax_root) == _cache_files(port_root)
    cached = JaxDataset(JaxConfig(LIB, cmd_args=jax_args)), Dataset(Config(LIB, cmd_args=port_args))
    _assert_same(*cached)
    return fresh[1]


def test_gowalla_ratio_split_identical(tmp_path):
    ds = _both(tmp_path, os.path.join(REPO, "dataset"), "gowalla", "UI", "','", "ratio", False)
    assert (ds.num_users, ds.num_items, ds.num_ratings) == (29858, 38546, 217242)


def _write_uirt(path, seed=0, n_users=40, n_items=60):
    rng = np.random.RandomState(seed)
    lines = []
    for u in rng.permutation(n_users)[:35]:
        n = rng.randint(1, 12)
        for i in rng.choice(n_items, n, replace=False):
            rating = rng.randint(1, 6)
            t = rng.randint(1000, 1100)  # repeated timestamps exercise the stable sort
            lines.append("%d\t%d\t%d\t%d" % (u * 7 + 3, i * 5 + 11, rating, t))
    order = rng.permutation(len(lines))
    path.write_text("\n".join(lines[j] for j in order) + "\n")


@pytest.mark.parametrize("splitter,by_time", [("ratio", True), ("ratio", False), ("loo", True), ("loo", False)])
def test_synthetic_uirt_splits_identical(tmp_path, splitter, by_time):
    data = tmp_path / "data"
    data.mkdir()
    _write_uirt(data / "syn.rating")
    _both(tmp_path, str(data), "syn", "UIRT", "'\\t'", splitter, by_time)


def test_config_parity():
    args = ["--recommender=LightGCN", "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--embed_size=32", "--topk=[20]", "--metric=[\"Recall\",\"NDCG\"]",
            "--n_layers=2", "--lr=0.005"]
    j, p = JaxConfig(LIB, cmd_args=args), Config(LIB, cmd_args=args)
    assert j.as_dict() == p.as_dict()
    assert str(j) == str(p)
    assert j.params_str() == p.params_str()
    for key in ("embed_size", "topk", "metric", "n_layers", "adj_type", "test_batch_size"):
        assert j[key] == p[key]


def test_negatives_protocol_not_ported(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_uirt(data / "syn.rating")
    args = _args(str(data), str(tmp_path / "c"), "syn", "UIRT", "'\\t'", "ratio", False)
    # the protocol is ported: 5 negatives a user, the JAX package's bytes
    ds = Dataset(Config(LIB, cmd_args=args + ["--rec.evaluate.neg=5"]))
    jax_args = _args(str(data), str(tmp_path / "j"), "syn", "UIRT", "'\\t'", "ratio", False)
    ds_j = JaxDataset(JaxConfig(LIB, cmd_args=jax_args + ["--rec.evaluate.neg=5"]))
    assert ds.get_user_test_neg_dict() == ds_j.get_user_test_neg_dict()
    assert all(len(v) == 5 for v in ds.get_user_test_neg_dict().values())
    port_files, jax_files = _cache_files(str(tmp_path / "c")), _cache_files(str(tmp_path / "j"))
    neg5 = [f for f in port_files if f.endswith(".neg5")]
    assert len(neg5) == 1 and port_files[neg5[0]] == jax_files[neg5[0]]
