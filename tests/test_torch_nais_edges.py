"""NAIS's and DeepICF's full-catalogue ``predict`` over a batch's train
edges, against the JAX package's ``lax.map`` over the padded rows, on the
CPU.

The port scores a batch over the (slot, item) pairs of its users' train
rows, padded with slot B to a static capacity, through ordered segment
sums. Held here, on a seeded ``random_dataset`` with skewed rows (user 0's
row emptied, one row at the set's longest):

* ``_edges``: each user's items contiguous and in its row's order, the
  pads after them in slot B with the set table's zero row, the segment
  lengths the row lengths and the pads';
* ``predict`` against the JAX ``predict`` (rtol / atol 1e-5) for NAIS's
  two algorithms with ``alpha`` and ``beta`` off their defaults and
  DeepICF with batch norm on and off, over batches with the empty row,
  the longest row and pad users (user 0 repeated), at the capacity
  ``predict_capacity`` gives, at the batch's exact edge count, at
  ``B * L_max`` (the default) and over item chunks;
* DeepICF's batch norm per user: a batch of users with different rows
  equals each user predicted alone and the JAX scores, and statistics
  pooled over the batch would not;
* the metric strings (to 1e-6, the same layout) and the top-K ids against
  the JAX ``Evaluator``'s, over batches whose edge counts differ (the
  capacity is their most), on the full catalogue, through a
  ``GroupedEvaluator``'s subsets and on the ``.neg`` candidate protocol;
* the serving export (``batch_topk``) against the JAX one: the same ids,
  scores to 1e-5; its capacity a power of two, part of its program's key;
* the evaluation and the export captured through a stub of the CUDA side
  under the guard against host reads: quiet, equal to ``graphs=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import InMemoryDataset as JaxInMemoryDataset
from neurec_tpu.eval import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.recommend import batch_topk as jax_batch_topk
from neurec_tpu_torch import recommend, step_graph
from neurec_tpu_torch.bridge import params_from_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.eval.evaluator import UniEvaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.general import deepicf, nais
from neurec_tpu_torch.recommend import batch_topk
from tests.test_torch_eval_graph import GuardedGraphs

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [5, 10], "metric": ["Precision", "Recall", "NDCG", "MRR"], "test_batch_size": 8}
CONFS = {
    "nais-prod": dict(recommender="NAIS", embedding_size=8, weight_size=4, alpha=0.3, beta=0.7, algorithm=0,
                      activation=0),
    "nais-concat": dict(recommender="NAIS", embedding_size=8, weight_size=6, alpha=-0.4, beta=0.3, algorithm=1,
                        activation=2),
    "deepicf-bn": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=True,
                       alpha=0.3, beta=0.6),
    "deepicf": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=False,
                    alpha=0.5, beta=0.4, activation=1),
}
NUM_USERS, NUM_ITEMS = 44, 70


def matrices(seed=3):
    """(train, test, negatives) CSR of a seeded set with skewed rows: user
    0's train row emptied, user 5's the longest."""
    ds = random_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS, min_per_user=3, max_per_user=24, seed=seed)
    train = ds.train_matrix.tolil()
    train[0, :] = 0
    rng = np.random.RandomState(seed)
    free = [i for i in range(NUM_ITEMS) if ds.test_matrix[5, i] == 0]
    for i in rng.choice(free, 40, replace=False):
        train[5, i] = 1.0
    train = sp.csr_matrix(train, dtype=np.float32)
    train.eliminate_zeros()
    test = ds.test_matrix.tocsr()
    neg = sp.lil_matrix((NUM_USERS, NUM_ITEMS), dtype=np.float32)
    for u in range(NUM_USERS):
        seen = set(train[u].indices) | set(test[u].indices)
        for i in rng.choice([i for i in range(NUM_ITEMS) if i not in seen], 9, replace=False):
            neg[u, i] = 1.0
    return train, test, sp.csr_matrix(neg)


def build_both(name, neg=False, **extra):
    train, test, negs = matrices()
    conf = dict(CONFS[name], **EVAL, **extra)
    ds_j = JaxInMemoryDataset(train, test, None, negs if neg else None)
    ds = InMemoryDataset(train, test, None, negs if neg else None)
    model_j = jax_get_model(conf["recommender"])(ds_j, JaxDictConfig(conf))
    model = get_model(conf["recommender"])(ds, DictConfig(conf), device="cpu")
    rng = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(7)))
    params_np = jax.tree_util.tree_map(lambda a: rng.uniform(-0.5, 0.5, a.shape).astype(np.float32), tree)
    return ds_j, ds, model_j, model, params_np, conf


def jax_scores(model_j, params_np, users):
    return np.asarray(model_j.predict(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users)))


def test_the_set_is_skewed():
    train = matrices()[0]
    lens = np.diff(train.indptr)
    assert lens[0] == 0 and lens.argmax() == 5 and lens[5] > 2 * np.median(lens)


@pytest.mark.parametrize("capacity", ["given", "exact", "roomy"])
def test_edges_hold_each_row_in_order(capacity):
    _, ds, _, model, _, _ = build_both("nais-prod")
    users = np.asarray([3, 0, 5, 9, 0, 0], np.int64)  # the empty row, the longest, pad users
    lens = np.diff(ds.train_matrix.indptr)[users]
    cap = {"given": model.predict_capacity(users[None]), "exact": int(lens.sum()),
           "roomy": int(lens.sum()) + 13}[capacity]
    assert cap >= lens.sum() and (capacity != "given" or cap % 8 == 0)
    item, slot, lengths = model._edges(torch.from_numpy(users), cap)
    assert item.shape == slot.shape == (cap,) and lengths[:len(users)].tolist() == lens.tolist()
    pad_lengths = lengths[len(users):].numpy()  # the pads in short segments
    assert pad_lengths.sum() == cap - lens.sum() and pad_lengths.max() <= nais._PAD_SEGMENT
    assert len(pad_lengths) == -(-cap // nais._PAD_SEGMENT)
    pads = cap - lens.sum()
    want_items = np.concatenate([np.sort(ds.train_matrix[u].indices) for u in users] + [[NUM_ITEMS] * pads])
    want_slots = np.concatenate([np.full(n, b) for b, n in enumerate(lens)] + [[len(users)] * pads])
    np.testing.assert_array_equal(item.numpy(), want_items)
    np.testing.assert_array_equal(slot.numpy(), want_slots)


def test_capacity_is_the_most_edges_of_a_batch_rounded_to_8():
    _, ds, _, model, _, _ = build_both("nais-prod")
    lens = np.diff(ds.train_matrix.indptr)
    users_b = np.arange(40).reshape(5, 8)
    most = max(int(lens[b].sum()) for b in users_b)
    assert model.predict_capacity(users_b) == -(-most // 8) * 8
    assert model.predict_capacity(np.zeros((2, 4), np.int64)) == 8  # only the empty row


@pytest.mark.parametrize("capacity", ["given", "exact", "default", "chunked"])
@pytest.mark.parametrize("name", sorted(CONFS))
def test_predict_matches_jax(name, capacity, monkeypatch):
    _, ds, model_j, model, params_np, _ = build_both(name)
    users = np.asarray([5, 0, 17, 3, 0, 0, 41], np.int32)  # longest, empty, pad users
    lens = np.diff(ds.train_matrix.indptr)[users]
    cap = {"given": model.predict_capacity(users[None]), "exact": int(lens.sum()), "default": None,
           "chunked": model.predict_capacity(users[None])}[capacity]
    if capacity == "chunked":
        monkeypatch.setattr(nais, "_TRANSIENT", cap * 6 * 5)  # 5 items a chunk
        monkeypatch.setattr(deepicf, "_TOWER", NUM_ITEMS * 8 * 3)  # 3 users a tower group
    params = params_from_numpy(params_np, "cpu")
    with torch.no_grad():
        got = model.predict(params, torch.from_numpy(users).long(), capacity=cap)
    want = jax_scores(model_j, params_np, users)
    assert got.shape == want.shape == (len(users), NUM_ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if name.startswith("nais"):  # the empty row attends to nothing: its scores are the bias
        np.testing.assert_allclose(got[1].numpy(), params_np["bias"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["nais-concat", "deepicf-bn"])
def test_trailing_pads_edges_are_dropped(name):
    """A capacity that holds only the real users' edges (``valid_b``):
    the pads after them lose theirs, and the real rows keep the JAX
    scores."""
    _, ds, model_j, model, params_np, _ = build_both(name)
    users = np.asarray([[3, 5, 9, 9]])
    valid = np.asarray([[1, 1, 0, 0]])
    lens = np.diff(ds.train_matrix.indptr)
    cap = model.predict_capacity(users, valid)
    assert cap == -(-(lens[3] + lens[5]) // 8) * 8 < lens[users].sum()
    with torch.no_grad():
        got = model.predict(params_from_numpy(params_np, "cpu"), torch.from_numpy(users[0]), capacity=cap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:2].numpy(), jax_scores(model_j, params_np, users[0, :2]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["deepicf-bn", "deepicf"])
def test_deepicf_statistics_are_per_user(name):
    _, _, model_j, model, params_np, _ = build_both(name)
    params = params_from_numpy(params_np, "cpu")
    users = torch.tensor([5, 0, 12, 30])
    cap = model.predict_capacity(users.numpy()[None])
    with torch.no_grad():
        batch = model.predict(params, users, capacity=cap)
        alone = torch.cat([model.predict(params, users[i:i + 1]) for i in range(len(users))])
        x = torch.cat([p * model._coeff(users)[:, :, None]
                       for _, p, _ in model._attend_edges(params, users, cap)], dim=1)
        pooled = model._prob(params, x, params["Q"], torch.arange(model.num_items))
    np.testing.assert_allclose(batch.numpy(), alone.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(batch.numpy(), jax_scores(model_j, params_np, users.numpy()), rtol=1e-5,
                               atol=1e-5)
    # batch norm over the users together gives other scores; without it the tower is per element
    assert np.allclose(pooled.numpy(), batch.numpy(), rtol=1e-5, atol=1e-6) == (name == "deepicf")


def jax_ids(model_j, params_np, ds, users, k):
    """The JAX scores' top-k ids with the train items masked, the lowest
    id first among ties."""
    scores = jax_scores(model_j, params_np, users).copy()
    for r, u in enumerate(users):
        scores[r, ds.train_matrix[u].indices] = -np.inf
    return np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])


@pytest.mark.parametrize("name", sorted(CONFS))
def test_metric_strings_and_ids_match_jax(name):
    ds_j, ds, model_j, model, params_np, conf = build_both(name)
    ev_j = JaxEvaluator.from_dataset(ds_j, JaxDictConfig(conf))
    ev = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu")
    inner = ev.evaluator
    inner.record_ids = True
    params = params_from_numpy(params_np, "cpu")
    s = ev.evaluate(model.predict, params)
    s_j = ev_j.evaluate(model_j.predict, jax.tree_util.tree_map(jnp.asarray, params_np))
    fields, fields_j = s.split("\t"), s_j.split("\t")
    assert ev.metrics_info() == ev_j.metrics_info() and [len(f) for f in fields] == [len(f) for f in fields_j]
    np.testing.assert_allclose([float(f) for f in fields], [float(f) for f in fields_j], atol=1e-6)
    # batches of different edge counts, the last padded with user 0; the
    # capacity is their most
    (kept,) = inner._kept.values()
    users_b = kept.batches[0].numpy()
    edges = np.diff(ds.train_matrix.indptr)[users_b].sum(axis=1)
    assert len(set(edges.tolist())) > 1 and (kept.batches[2].numpy() == 0).any()
    n = len(inner.test_users)
    np.testing.assert_array_equal(inner.last_ids[:n].numpy(), jax_ids(model_j, params_np, ds, inner.test_users, 10))


@pytest.mark.parametrize("name", ["nais-concat", "deepicf-bn"])
def test_grouped_and_candidate_strings_match_jax(name):
    for extra, neg in (({"group_view": [4, 10, 60]}, False), ({}, True)):
        ds_j, ds, model_j, model, params_np, conf = build_both(name, neg=neg, **extra)
        ev_j = JaxEvaluator.from_dataset(ds_j, JaxDictConfig(conf))
        ev = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu")
        s = ev.evaluate(model.predict, params_from_numpy(params_np, "cpu"))
        s_j = ev_j.evaluate(model_j.predict, jax.tree_util.tree_map(jnp.asarray, params_np))
        rows, rows_j = s.strip("\n").split("\n"), s_j.strip("\n").split("\n")
        assert len(rows) == len(rows_j) == (3 if extra else 1)
        for row, row_j in zip(rows, rows_j):
            fields, fields_j = row.split("\t"), row_j.split("\t")
            assert [len(f) for f in fields] == [len(f) for f in fields_j]
            if extra:
                assert fields[0] == fields_j[0]
                fields, fields_j = fields[1:], fields_j[1:]
            np.testing.assert_allclose([float(f) for f in fields], [float(f) for f in fields_j], atol=1e-6)


@pytest.mark.parametrize("name", ["nais-prod", "deepicf-bn"])
def test_serving_export_matches_jax(name):
    ds_j, ds, model_j, model, params_np, _ = build_both(name)
    sel = np.asarray([5, 0, 9, 9, 30, 2, 11, 0, 40, 23, 14], np.int32)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params = params_from_numpy(params_np, "cpu")
    recommend._EXPORT_CACHE.clear()
    for users, batch_size in ((sel, 4), (None, 16)):
        ids_j, sc_j = jax_batch_topk(model_j, params_j, 7, users=users, batch_size=batch_size,
                                     train_matrix=ds_j.train_matrix)
        ids, sc = batch_topk(model, params, 7, users=users, batch_size=batch_size, train_matrix=ds.train_matrix,
                             device="cpu")
        np.testing.assert_array_equal(ids, np.asarray(ids_j))
        np.testing.assert_allclose(sc, np.asarray(sc_j), rtol=1e-5, atol=1e-5)
    caps = [key[1][6] for key in recommend._EXPORT_CACHE if key[0] == id(model)]
    assert len(caps) == 2 and all(c >= 8 and c & (c - 1) == 0 for c in caps)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_captured_under_the_host_read_guard(name, monkeypatch):
    """The evaluation (catalogue and candidates) and the export captured
    through the stub, the guard quiet, the replays equal to
    ``graphs=False``."""
    for neg in (False, True):
        _, ds, _, model, params_np, conf = build_both(name, neg=neg)
        params = params_from_numpy(params_np, "cpu")
        eager = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu", graphs=False).evaluate(model.predict,
                                                                                                  params)
        monkeypatch.setattr(step_graph, "_CudaGraphs", GuardedGraphs)
        GuardedGraphs.made = []
        forced = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu")
        monkeypatch.setattr(forced.evaluator, "_captures", lambda fn: True)
        forced.evaluate(model.predict, params)
        assert forced.evaluate(model.predict, params) == eager
        assert len(GuardedGraphs.made) == 1
        monkeypatch.undo()
    want = batch_topk(model, params, 6, batch_size=8, train_matrix=ds.train_matrix, device="cpu", graphs=False)
    monkeypatch.setattr(step_graph, "_CudaGraphs", GuardedGraphs)
    monkeypatch.setattr(recommend, "_captures", lambda model, device: True)
    GuardedGraphs.made = []
    for _ in range(2):
        got = batch_topk(model, params, 6, batch_size=8, train_matrix=ds.train_matrix, device="cpu")
    assert len(GuardedGraphs.made) == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_a_bigger_batch_set_gets_its_own_capacity():
    """Each batch set's program takes its own batches' capacity: a subset
    with the longest row gets a larger one than a subset without it."""
    _, ds, _, model, params_np, conf = build_both("nais-prod")
    ev = UniEvaluator(ds.get_user_train_dict(), ds.get_user_test_dict(), metric=EVAL["metric"],
                      top_k=EVAL["topk"], batch_size=8, num_items=NUM_ITEMS, device="cpu")
    seen = []
    real = model.predict

    def spy(params, users, capacity=None):
        seen.append(capacity)
        return real(params, users, capacity)

    model.predict = spy
    spy.__func__, spy.__self__ = type(model).predict, model  # as a bound method looks
    params = params_from_numpy(params_np, "cpu")
    lens = np.diff(ds.train_matrix.indptr)
    small = [u for u in ev.test_users if u != 5][:8]
    ev.evaluate(model.predict, params, small)
    ev.evaluate(model.predict, params, [5] + small[:7])
    assert seen == [model.predict_capacity(np.asarray([small])),
                    model.predict_capacity(np.asarray([[5] + small[:7]]))]
    assert seen[1] > seen[0] >= lens[small].sum()
