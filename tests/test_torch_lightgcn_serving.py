"""The slice as a whole: LightGCN serving in the port against the JAX package.

A synthetic graph above ``DENSE_LIMIT`` puts the port on the plan branch
(K2's plain version on the CPU); the JAX package takes its own CPU branch.
Parameters are made with numpy and carried into both packages.

Tolerances: propagated tables to atol 1e-5, evaluation metrics to 1e-6.
Top-K ids are identical except where two scores differ by less than 1e-5
in float noise (different summation orders in the two packages); exact
ties resolve to the lowest item id in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.recommend import batch_topk as jax_batch_topk
from neurec_tpu_torch.bridge import params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import graph
from neurec_tpu_torch.recommend import batch_topk

torch.set_float32_matmul_precision("highest")

N_USERS, N_ITEMS, D = 6000, 3000, 16
CONF = {"embed_size": D, "n_layers": 3, "adj_type": "pre", "topk": [5, 20],
        "test_batch_size": 1024, "metric": ["Precision", "Recall", "MAP", "NDCG", "MRR"]}


@pytest.fixture(scope="module")
def serving():
    ds_j = jax_random_dataset(num_users=N_USERS, num_items=N_ITEMS, seed=11)
    ds = random_dataset(num_users=N_USERS, num_items=N_ITEMS, seed=11)
    assert (ds.train_matrix != ds_j.train_matrix).nnz == 0
    conf_j, conf = JaxDictConfig(CONF), DictConfig(CONF)
    model_j = jax_get_model("LightGCN")(ds_j, conf_j)
    model = get_model("LightGCN")(ds, conf, device="cpu")
    assert model.adj.dense is None and model.adj.plan is not None  # plan branch
    rng = np.random.RandomState(5)
    params_np = {
        "user_emb": rng.uniform(-0.1, 0.1, (N_USERS, D)).astype(np.float32),
        "item_emb": rng.uniform(-0.1, 0.1, (N_ITEMS, D)).astype(np.float32),
    }
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_numpy(params_np, "cpu")
    return ds_j, ds, conf_j, conf, model_j, model, params_j, params


def test_bridge_round_trip():
    p = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.int32)}
    back = params_to_numpy(params_from_numpy(p, "cpu"))
    for k in p:
        assert back[k].dtype == p[k].dtype
        np.testing.assert_array_equal(back[k], p[k])


def test_propagate_matches_jax(serving):
    _, _, _, _, model_j, model, params_j, params = serving
    assert (N_USERS + N_ITEMS) ** 2 > graph.DENSE_LIMIT
    u_j, i_j = model_j.propagate(params_j)
    u, i = model.propagate(params)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(i.numpy(), np.asarray(i_j), atol=1e-5, rtol=0)


def test_evaluator_matches_jax(serving):
    ds_j, ds, conf_j, conf, model_j, model, params_j, params = serving
    ev_j = JaxEvaluator.from_dataset(ds_j, conf_j)
    ev = Evaluator.from_dataset(ds, conf, device="cpu")
    assert ev.metrics_info() == ev_j.metrics_info()
    raw_j = ev_j.evaluator.evaluate_raw(model_j.predict, params_j)
    raw = ev.evaluator.evaluate_raw(model.predict, params)
    assert raw.shape == raw_j.shape == (5, 2) and raw.dtype == np.float32
    np.testing.assert_allclose(raw, raw_j, atol=1e-6, rtol=0)
    s_j, s = ev_j.evaluate(model_j.predict, params_j), ev.evaluate(model.predict, params)
    fields_j, fields = s_j.split("\t"), s.split("\t")
    assert [len(f) for f in fields] == [len(f) for f in fields_j]
    np.testing.assert_allclose([float(f) for f in fields], [float(f) for f in fields_j], atol=1e-6)


def test_grouped_evaluator_layout_matches_jax(serving):
    ds_j, ds, conf_j, conf, model_j, model, params_j, params = serving
    grouped = dict(CONF, group_view=[4, 8, 16])
    s_j = JaxEvaluator.from_dataset(ds_j, JaxDictConfig(grouped)).evaluate(model_j.predict, params_j)
    s = Evaluator.from_dataset(ds, DictConfig(grouped), device="cpu").evaluate(model.predict, params)
    lines_j, lines = s_j.split("\n"), s.split("\n")
    assert [ln.split("\t")[0] for ln in lines] == [ln.split("\t")[0] for ln in lines_j]
    for a, b in zip(lines[1:], lines_j[1:]):
        np.testing.assert_allclose([float(x) for x in a.split("\t")[1:]],
                                   [float(x) for x in b.split("\t")[1:]], atol=1e-6)


def _assert_same_topk(items, scores, items_j, scores_j):
    assert items.dtype == np.int32 and scores.dtype == np.float32
    assert items.shape == items_j.shape
    differ = items != items_j
    # only near-ties (float noise below 1e-5) may reorder ids
    assert differ.mean() < 1e-3
    np.testing.assert_allclose(scores, scores_j, atol=1e-5, rtol=0)
    if differ.any():
        assert np.abs(scores - scores_j)[differ].max() < 1e-5


def test_batch_topk_matches_jax(serving):
    ds_j, ds, _, _, model_j, model, params_j, params = serving
    users = np.arange(0, N_USERS, 7, dtype=np.int32)
    items_j, scores_j = jax_batch_topk(model_j, params_j, 20, users=users,
                                       train_matrix=ds_j.train_matrix, batch_size=256)
    items, scores = batch_topk(model, params, 20, users=users, train_matrix=ds.train_matrix,
                               batch_size=256, device="cpu")
    _assert_same_topk(items, scores, np.asarray(items_j), np.asarray(scores_j))
    for u, row in zip(users, items):  # no consumed item is served
        assert not set(row.tolist()) & set(ds.train_matrix[u].indices.tolist())
    # k is clamped to the catalogue size
    few = users[:3]
    items_j, scores_j = jax_batch_topk(model_j, params_j, N_ITEMS + 9, users=few)
    items, scores = batch_topk(model, params, N_ITEMS + 9, users=few, device="cpu")
    assert items.shape == (3, N_ITEMS)
    _assert_same_topk(items, scores, np.asarray(items_j), np.asarray(scores_j))


class _JaxDot:
    """Minimal scoring model (user rows @ item rows^T) for the tie test."""

    def __init__(self, n_users, n_items):
        self.num_users, self.num_items = n_users, n_items

    def predict(self, params, users):
        return params["u"][users] @ params["i"].T


class _TorchDot(_JaxDot):
    device = torch.device("cpu")


def test_batch_topk_exact_ties_lowest_id_first():
    rng = np.random.RandomState(0)
    n_users, n_items = 40, 90
    u = (rng.randint(-2, 3, (n_users, 4)) / 2).astype(np.float32)
    it = (rng.randint(-2, 3, (n_items, 4)) / 2).astype(np.float32)  # many exact ties
    it[60:] = it[:30]
    items_j, scores_j = jax_batch_topk(_JaxDot(n_users, n_items), {"u": jnp.asarray(u), "i": jnp.asarray(it)},
                                       25, batch_size=16)
    items, scores = batch_topk(_TorchDot(n_users, n_items), params_from_numpy({"u": u, "i": it}, "cpu"),
                               25, batch_size=16, device="cpu")
    np.testing.assert_array_equal(items, np.asarray(items_j))
    np.testing.assert_array_equal(scores, np.asarray(scores_j))
    s = u @ it.T
    for r in range(n_users):  # ties descend to ascending ids
        want = sorted(range(n_items), key=lambda j: (-s[r, j], j))[:25]
        assert items[r].tolist() == want
