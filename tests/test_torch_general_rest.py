"""The rest of the general models (Pop, ItemKNN, MultiDAE, MultiVAE, DAE,
CDAE, SpectralCF, WRMF, JCA, CFGAN, IRGAN) against the JAX package's, on
the CPU.

Each model is built in both packages on the same ``random_dataset``; the
JAX ``init_params`` gives the tree, every float leaf redrawn from numpy
U(-0.5, 0.5) (ItemKNN and Pop keep theirs: their params are computed from
the data), carried into the port by the bridge. Then:

* one batch (some weights 0): ``loss`` and every gradient against
  ``jax.value_and_grad`` of the JAX loss in float64, rtol 1e-5 / atol 1e-6.
  Where the JAX loss draws (dropout, corruption, the VAE's noise, CDAE's
  negatives) the test rebuilds its draws from ``batch["rng"]`` and hands
  them to the port's draw methods, so that both take the same numbers;
* ``predict`` against the JAX ``predict``, rtol / atol 1e-5, and
  ``eval_embeddings`` (the factorized form K1 ranks) against ``predict``;
* the evaluation string against the JAX ``Evaluator``'s, 1e-6 a field with
  the same layout, and the same top-K ids, ties included;
* ItemKNN: all eight similarity modes give the JAX (I, K) neighbour ids,
  and weights within 1e-6; SpectralCF: A_hat has JAX's bits.

The epochs are tested in test_torch_dense_row_epoch.py and
test_torch_custom_epochs.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import InMemoryDataset as JaxInMemoryDataset
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.ops.sampling import sample_negatives as jax_sample_negatives
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops.topk import top_k

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 16}
CONFS = {
    "pop": dict(recommender="Pop"),
    "itemknn": dict(recommender="ItemKNN", neighbor=5, similarity="cosine", knn_block=16),
    "multidae": dict(recommender="MultiDAE", p_dim=[8, 16], reg=0.01, keep_prob=0.8),
    "multivae": dict(recommender="MultiVAE", p_dim=[8, 16], reg=0.01, total_anneal_steps=20, anneal_cap=0.2),
    "dae": dict(recommender="DAE", hidden_neuron=10, corruption_level=0.3, reg=0.01),
    "dae-softmax": dict(recommender="DAE", hidden_neuron=10, h_act="tanh", g_act="softmax", reg=0.01),
    "cdae": dict(recommender="CDAE", hidden_dim=8, num_neg=2, dropout=0.5, reg=0.01),
    "cdae-square": dict(recommender="CDAE", hidden_dim=8, num_neg=2, dropout=0.0, reg=0.01,
                        loss_func="square", hidden_act="identity"),
    "spectralcf": dict(recommender="SpectralCF", embedding_size=8, num_layers=2, reg=0.01),
    "wrmf": dict(recommender="WRMF", embedding_size=8, alpha=10.0, reg_mf=0.1),
    "jca": dict(recommender="JCA", hidden_neuron=8, reg=0.01, f_act="tanh", g_act="sigmoid", num_neg=2),
    "cfgan": dict(recommender="CFGAN", hiddenLayer_G=[12], hiddenLayer_D=[6], batchSize_G=8, batchSize_D=8,
                  step_G=2, step_D=1, mode="userBased", reg_D=0.01, epochs=4),
    "cfgan-item": dict(recommender="CFGAN", hiddenLayer_G=[12], hiddenLayer_D=[6], batchSize_G=8, batchSize_D=8,
                       step_G=1, step_D=2, mode="itemBased", opt_G="sgd", lr_G=0.05, epochs=4),
    "irgan": dict(recommender="IRGAN", factors_num=4, d_reg=0.01, g_reg=0.01, lr=0.05),
}
for _c in CONFS.values():
    _c.update(EVAL, batch_size=16, learner="adam", learning_rate=0.01)

SIZE = (40, 60)
# the models whose params are computed from the data, not drawn
COMPUTED = ("Pop", "ItemKNN")


def rated_dataset(pkg_dataset_cls, ds, seed):
    """``ds`` with rating values U(1, 5) in place of the ones."""
    train = ds.train_matrix.tocsr().copy()
    train.data = np.random.RandomState(seed).uniform(1.0, 5.0, train.nnz).astype(np.float32)
    return pkg_dataset_cls(sp.csr_matrix(train), ds.test_matrix, None)


def build_both(conf, size=SIZE, seed=1, rated=False):
    ds_j = jax_random_dataset(num_users=size[0], num_items=size[1], seed=seed)
    ds = random_dataset(num_users=size[0], num_items=size[1], seed=seed)
    if rated:
        ds_j, ds = rated_dataset(JaxInMemoryDataset, ds_j, seed), rated_dataset(InMemoryDataset, ds, seed)
    model_j = jax_get_model(conf["recommender"])(ds_j, JaxDictConfig(conf))
    model = get_model(conf["recommender"])(ds, DictConfig(conf), device="cpu")
    return ds_j, ds, model_j, model


def numpy_params(model_j, seed, scale=0.5):
    """The JAX init's tree, every leaf redrawn from U(-scale, scale), or as
    it is for the models whose params are computed."""
    tree = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(seed)))
    if type(model_j).__name__ in COMPUTED:
        return tree
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32), tree)


def trainable(params_np):
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    return params


def inject(model, **draws):
    """Hand the port's draw methods the given draws, in call order: each
    call of ``model._<name>`` returns the next tensor of ``draws[name]``."""
    for name, seq in draws.items():
        it = iter(seq)
        setattr(model, "_" + name, lambda *args, _it=it: next(_it))


def jax_loss_draws(model_j, key, users, rows):
    """The draws the JAX loss of a dense_row model makes from ``key``, by
    the port's draw method they stand in for (neurec_tpu/models/general/
    multidae.py:51, multivae.py:101-104, dae.py:60, cdae.py:76-83)."""
    name = type(model_j).__name__
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if name == "MultiDAE":
        return {"bernoulli": [t(jax.random.bernoulli(key, model_j.keep_prob, rows.shape))]}
    if name == "MultiVAE":
        k_drop, k_eps = jax.random.split(key)
        return {"bernoulli": [t(jax.random.bernoulli(k_drop, model_j.keep_prob, rows.shape))],
                "normal": [t(jax.random.normal(k_eps, (rows.shape[0], model_j.q_dims[-1]))).float()]}
    if name == "DAE":
        if model_j.corruption_level <= 0:
            return {}
        return {"bernoulli": [t(jax.random.bernoulli(key, 1.0 - model_j.corruption_level, rows.shape))]}
    if name == "CDAE":
        k_neg, k_drop = jax.random.split(key)
        pos_rows = model_j._padded_items[jnp.asarray(users)]
        negs = jax_sample_negatives(k_neg, pos_rows, model_j.num_items, (pos_rows.shape[1] * model_j.num_neg,))
        out = {"negatives": [t(negs).long()]}
        if model_j.dropout > 0:
            out["bernoulli"] = [t(jax.random.bernoulli(k_drop, 1.0 - model_j.dropout, rows.shape))]
        return out
    return {}


def make_batch(model, seed, B=24):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, model.num_users, B).astype(np.int32)
    w = (rng.rand(B) < 0.75).astype(np.float32)
    if model.data_kind == "pairwise":
        return {"users": users, "pos_items": rng.randint(0, model.num_items, B).astype(np.int32),
                "neg_items": rng.randint(0, model.num_items, B).astype(np.int32)}, w
    rows = model.make_rows(torch.from_numpy(users).long()).numpy()
    return {"users": users, "rows": rows}, w


LOSS_CASES = ["multidae", "multivae", "dae", "dae-softmax", "cdae", "cdae-square", "spectralcf"]
# cdae-square's identity hidden layer makes its squared errors large: smaller
# factors keep its f32 gradients' cancellation inside the bar
SCALE = {"cdae-square": 0.2}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_and_gradients_match_jax(name):
    conf = CONFS[name]
    _, _, model_j, model = build_both(conf)
    assert model.data_kind == model_j.data_kind
    params_np = numpy_params(model_j, 2, SCALE.get(name, 0.5))
    batch, w = make_batch(model, 3)
    step = 7
    key = jax.random.PRNGKey(11)
    with jax.enable_x64():
        b64 = {k: jnp.asarray(v, jnp.float64) if v.dtype == np.float32 else jnp.asarray(v) for k, v in batch.items()}
        b64.update(rng=key, step=jnp.int32(step), epoch=jnp.int32(1))
        want_loss, want_grads = jax.value_and_grad(model_j.loss)(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params_np), b64, jnp.asarray(w, jnp.float64))
        want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
        rows = batch.get("rows", np.zeros((len(w), 0)))
        inject(model, **jax_loss_draws(model_j, key, batch["users"], rows))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}
    tb.update(step=step, epoch=1, generator=torch.Generator().manual_seed(0))
    params = trainable(params_np)
    loss = model.loss(params, tb, torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-6)
    got = list(param_leaves(params))
    assert {path for path, _ in got} == set(want)
    for path, p in got:
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(grad, want[path], rtol=1e-5, atol=1e-6, err_msg=str(path))


def test_multivae_anneals_the_kl_term_by_the_global_step():
    """anneal = min(cap, step / total_anneal_steps): the loss moves with
    ``batch["step"]`` until the cap, and not after it."""
    conf = CONFS["multivae"]
    _, _, model_j, model = build_both(conf)
    params = params_from_numpy(numpy_params(model_j, 2), "cpu")
    batch, w = make_batch(model, 3)
    tb = {"users": torch.from_numpy(batch["users"]).long(), "rows": torch.from_numpy(batch["rows"])}
    losses = []
    for step in (0, 2, 4, 100, 200):
        tb.update(step=step, generator=torch.Generator().manual_seed(5))
        losses.append(float(model.loss(params, tb, torch.from_numpy(w))))
    assert losses[0] != losses[1] != losses[2]
    assert losses[3] == losses[4]  # past total_anneal_steps * anneal_cap
    np.testing.assert_allclose(losses[2] - losses[0], 2 * (losses[1] - losses[0]), rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_predict_matches_jax(name):
    conf = CONFS[name]
    _, _, model_j, model = build_both(conf)
    params_np = numpy_params(model_j, 4)
    users = np.array([0, 3, 7, 11, 39], dtype=np.int32)
    want = np.asarray(model_j.predict(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users)))
    with torch.no_grad():
        got = model.predict(params_from_numpy(params_np, "cpu"), torch.from_numpy(users).long())
    assert got.shape == want.shape == (len(users), model.num_items)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


FACTORIZED = [("pop", 1), ("multidae", 17), ("multivae", 17), ("cdae", 9), ("cdae-square", 9), ("spectralcf", 24),
              ("wrmf", 8), ("irgan", 5)]


@pytest.mark.parametrize("name,d", FACTORIZED)
def test_factorized_models_feed_k1(name, d):
    """The models K1 ranks: ``eval_embeddings`` at the width K1 takes (the
    last hidden width plus a folded bias where there is one), its product
    equal to ``predict``, and the JAX package's factors."""
    _, _, model_j, model = build_both(CONFS[name])
    params_np = numpy_params(model_j, 6)
    params = params_from_numpy(params_np, "cpu")
    users = torch.arange(0, 40, 4)
    with torch.no_grad():
        u, items = model.eval_embeddings(params, users)
        assert u.shape == (10, d) and items.shape == (model.num_items, d)
        np.testing.assert_allclose((u @ items.T).numpy(), model.predict(params, users).numpy(), rtol=1e-5, atol=1e-5)
    u_j, items_j = model_j.eval_embeddings(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users.numpy()))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_evaluation_string_matches_jax(name):
    conf = CONFS[name]
    ds_j, ds, model_j, model = build_both(conf)
    params_np = numpy_params(model_j, 5)
    ev_j = JaxEvaluator.from_dataset(ds_j, JaxDictConfig(conf))
    ev = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu")
    s_j = ev_j.evaluate(model_j.predict, jax.tree_util.tree_map(jnp.asarray, params_np))
    s = ev.evaluate(model.predict, params_from_numpy(params_np, "cpu"))
    fields_j, fields = s_j.split("\t"), s.split("\t")
    assert ev.metrics_info() == ev_j.metrics_info() and len(fields) == len(fields_j) == 4
    assert [len(f) for f in fields] == [len(f) for f in fields_j]
    np.testing.assert_allclose([float(f) for f in fields], [float(f) for f in fields_j], atol=1e-6)


@pytest.mark.parametrize("name", ["pop", "itemknn", "wrmf", "irgan"])
def test_top_k_ids_match_jax_ties_included(name):
    """The ranked ids of every test user, train items masked, equal
    ``lax.top_k``'s: Pop's counts tie everywhere, the lowest id first."""
    _, ds, model_j, model = build_both(CONFS[name])
    params_np = numpy_params(model_j, 8)
    users = np.arange(model.num_users, dtype=np.int32)
    scores_j = model_j.predict(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users))
    train = jnp.asarray(ds.train_matrix.toarray() > 0)
    want = np.asarray(jax.lax.top_k(jnp.where(train, -jnp.inf, scores_j), 10)[1])
    with torch.no_grad():
        scores = model.predict(params_from_numpy(params_np, "cpu"), torch.from_numpy(users).long())
    got = top_k(torch.where(torch.from_numpy(ds.train_matrix.toarray() > 0), float("-inf"), scores), 10)[1]
    np.testing.assert_array_equal(got.numpy(), want)


KNN_MODES = ["cosine", "asymmetric", "adjusted", "pearson", "jaccard", "dice", "tversky", "euclidean"]


@pytest.mark.parametrize("mode", KNN_MODES)
def test_itemknn_neighbours_match_jax(mode):
    """Every similarity mode on rated data, shrink on: the (I, K) neighbour
    ids equal the JAX package's and the weights agree to 1e-6."""
    conf = dict(CONFS["itemknn"], similarity=mode, shrink=2.0, asymmetric_alpha=0.3, tversky_alpha=0.7,
                tversky_beta=0.4, neighbor=6)
    _, _, model_j, model = build_both(conf, rated=True)
    want = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    got = model.init_params(torch.Generator())
    np.testing.assert_array_equal(got["w_idx"].numpy(), want["w_idx"])
    np.testing.assert_allclose(got["w_vals"].numpy(), want["w_vals"], rtol=1e-6, atol=1e-6)
    for key in ("row_offsets", "flat_items", "flat_vals"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_itemknn_blocks_leave_the_neighbours_as_they_are():
    """One column block or many (a ragged last one): the same weights."""
    wide = build_both(dict(CONFS["itemknn"], knn_block=512))[3].init_params(torch.Generator())
    narrow = build_both(dict(CONFS["itemknn"], knn_block=7))[3].init_params(torch.Generator())
    assert torch.equal(wide["w_idx"], narrow["w_idx"]) and torch.equal(wide["w_vals"], narrow["w_vals"])


def test_spectralcf_a_hat_has_the_jax_bits():
    _, _, model_j, model = build_both(CONFS["spectralcf"])
    assert model._A_hat.dtype == torch.float32
    np.testing.assert_array_equal(model._A_hat.numpy(), np.asarray(model_j._A_hat))


def test_spectralcf_refuses_more_than_20000_nodes():
    ds = random_dataset(num_users=19990, num_items=11, min_per_user=1, max_per_user=2, seed=0)
    with pytest.raises(ValueError, match="20001 nodes"):
        get_model("SpectralCF")(ds, DictConfig(CONFS["spectralcf"]), device="cpu")


@pytest.mark.parametrize("name", ["jca", "cfgan-item"])
def test_dense_eval_hook_follows_the_budget(name):
    """JCA and CFGAN (itemBased) offer every user's scores at once for the
    evaluator's hoist, equal to ``predict``; JCA un-advertises it above
    12 U I bytes > 512 MB, CFGAN in userBased mode."""
    _, _, model_j, model = build_both(CONFS[name])
    params = params_from_numpy(numpy_params(model_j, 12), "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(model.eval_dense_scores(params)[[4, 8]].numpy(),
                                   model.predict(params, torch.tensor([4, 8])).numpy(), rtol=1e-5, atol=1e-6)
    assert build_both(CONFS["cfgan"])[3].eval_dense_scores is None
    big = InMemoryDataset(sp.csr_matrix(([1.0], ([0], [0])), shape=(4000, 12000)),
                          sp.csr_matrix((4000, 12000)), None)
    assert get_model("JCA")(big, DictConfig(CONFS["jca"]), device="cpu").eval_dense_scores is None


def test_jca_predict_over_item_chunks(monkeypatch):
    from neurec_tpu_torch.models.general import jca

    _, _, model_j, model = build_both(CONFS["jca"])
    params = params_from_numpy(numpy_params(model_j, 13), "cpu")
    users = torch.tensor([1, 5, 9, 30])
    with torch.no_grad():
        whole = model.predict(params, users)
        monkeypatch.setattr(jca, "_TRANSIENT", 7 * model.num_users)
        chunked = model.predict(params, users)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_pop_scores_are_the_train_counts():
    _, ds, _, model = build_both(CONFS["pop"])
    params = model.init_params(torch.Generator())
    counts = np.asarray((ds.train_matrix != 0).sum(axis=0)).reshape(-1)
    np.testing.assert_array_equal(params["item_count"].numpy(), counts.astype(np.float32))
    with pytest.raises(RuntimeError, match="no training loss"):
        model.loss(params, {}, None)
