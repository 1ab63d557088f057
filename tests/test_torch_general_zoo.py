"""The general models of the pairwise and pointwise epochs (MLP, NeuMF, APR,
FISM, NAIS, DeepICF, DMF, ConvNCF) against the JAX package's, on the CPU.

Each model is built in both packages on the same ``random_dataset`` (DMF's
with random rating values). The JAX ``init_params`` gives the tree; every
leaf is redrawn from numpy U(-0.5, 0.5) so that the products are not
all near zero, and the bridge carries it into the port. Then:

* one batch (some weights 0): the ``loss`` value and every parameter
  gradient against ``jax.value_and_grad`` of the same JAX function run in
  float64 (``jax.enable_x64``), rtol 1e-5 / atol 1e-6: the port's f32 is
  held to the exact value. (The JAX f32 run itself misses that bar by up
  to 3x on ConvNCF's conv bias gradients, a sum over every pixel of the
  batch that XLA's CPU convolution adds in another order; the port's f32
  stays within 0.4 of it, APR's adversarial gradient and NAIS's softmax
  included.) A leaf the loss does not reach (DeepICF's batch norm when
  it is off) has no gradient in the port and zeros in JAX;
* ``predict`` against the JAX ``predict``, rtol / atol 1e-5;
* the evaluation string against the JAX ``Evaluator``'s, to 1e-6 a field
  with the same layout (APR and FISM evaluate factorized, through K1's
  plain version; the rest through ``predict``).

APR's random perturbation cannot match draw for draw (threefry against
torch's generator): its loss is held to the JAX one with the adversarial
term switched off by ``adv_epoch``, and its perturbation to the row norm
``eps``.
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
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 16}
CONFS = {
    "mlp-bpr": dict(recommender="MLP", layers=[16, 8, 4], reg_mlp=0.01, is_pairwise=True, loss_function="bpr"),
    "mlp-ce": dict(recommender="MLP", layers=[16, 8, 4], reg_mlp=0.01, is_pairwise=False,
                   loss_function="cross_entropy", num_neg=2),
    "neumf-ce": dict(recommender="NeuMF", embedding_size=4, layers=[16, 8, 4], reg_mf=0.01, reg_mlp=0.02,
                     is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "neumf-bpr": dict(recommender="NeuMF", embedding_size=4, layers=[16, 8, 4], reg_mf=0.01, reg_mlp=0.02,
                      is_pairwise=True, loss_function="bpr"),
    "apr-grad": dict(recommender="APR", embedding_size=8, reg=0.01, reg_adv=1.0, adv="grad", eps=0.5,
                     adv_epoch=0),
    "apr-grad-off": dict(recommender="APR", embedding_size=8, reg=0.01, adv="grad", adv_epoch=5),
    "fism-square": dict(recommender="FISM", embedding_size=8, alpha=0.5, is_pairwise=False,
                        loss_function="square", num_neg=2, **{"lambda": 0.01, "gamma": 0.02}),
    "fism-bpr": dict(recommender="FISM", embedding_size=8, alpha=0.5, is_pairwise=True,
                     loss_function="bpr", **{"lambda": 0.01, "gamma": 0.02}),
    "nais-prod": dict(recommender="NAIS", embedding_size=8, weight_size=4, regs=[0.01, 0.02, 0.03],
                      alpha=0.3, beta=0.5, algorithm=0, activation=0, is_pairwise=False,
                      loss_function="cross_entropy", num_neg=2),
    "nais-concat": dict(recommender="NAIS", embedding_size=8, weight_size=4, regs=[0.01, 0.02, 0.03],
                        alpha=0.3, beta=0.7, algorithm=1, activation=1, is_pairwise=True,
                        loss_function="bpr"),
    "deepicf-bn": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=True,
                       regs=[0.01, 0.02, 0.03], alpha=0.3, beta=0.5, num_neg=2),
    "deepicf": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=False,
                    regs=[0.01, 0.02, 0.03], alpha=0.0, beta=0.5, activation=2, num_neg=2),
    "dmf-ce": dict(recommender="DMF", layers=[16, 8], loss_function="cross_entropy", num_negatives=2),
    "dmf-square": dict(recommender="DMF", layers=[16, 8], loss_function="square", num_negatives=2),
    "convncf": dict(recommender="ConvNCF", embedding_size=8, net_channel=[4, 4, 4], regs=[0.01, 0.02, 0.03],
                    lr_embed=0.05, lr_net=0.02, keep=1.0),
}
for _c in CONFS.values():
    _c.update(EVAL, batch_size=32, learner="adam", learning_rate=0.01)

SIZE = (40, 60)


def rated_dataset(pkg_dataset_cls, ds, seed):
    """``ds`` with rating values U(1, 5) in place of the ones (DMF's towers
    take the values)."""
    train = ds.train_matrix.tocsr().copy()
    train.data = np.random.RandomState(seed).uniform(1.0, 5.0, train.nnz).astype(np.float32)
    return pkg_dataset_cls(sp.csr_matrix(train), ds.test_matrix, None)


def build_both(conf, size=SIZE, seed=1):
    ds_j = jax_random_dataset(num_users=size[0], num_items=size[1], seed=seed)
    ds = random_dataset(num_users=size[0], num_items=size[1], seed=seed)
    if conf["recommender"] == "DMF":
        ds_j, ds = rated_dataset(JaxInMemoryDataset, ds_j, seed), rated_dataset(InMemoryDataset, ds, seed)
    model_j = jax_get_model(conf["recommender"])(ds_j, JaxDictConfig(conf))
    model = get_model(conf["recommender"])(ds, DictConfig(conf), device="cpu")
    return ds_j, ds, model_j, model


def numpy_params(model_j, seed, scale=0.5):
    """The JAX init's tree, every leaf redrawn from U(-scale, scale)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32), tree)


def make_batch(model, seed, B=24, epoch=1):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, model.num_users, B).astype(np.int32)
    w = (rng.rand(B) < 0.75).astype(np.float32)
    if model.data_kind == "pairwise":
        batch = {"users": users, "pos_items": rng.randint(0, model.num_items, B).astype(np.int32),
                 "neg_items": rng.randint(0, model.num_items, B).astype(np.int32)}
    else:
        batch = {"users": users, "items": rng.randint(0, model.num_items, B).astype(np.int32),
                 "labels": (rng.rand(B) < 0.4).astype(np.float32)}
    return batch, w, epoch


def jax_batch(batch, epoch, seed=0):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["epoch"] = jnp.int32(epoch)
    out["rng"] = jax.random.PRNGKey(seed)
    return out


def torch_batch(batch, epoch):
    out = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}
    out["epoch"] = epoch
    return out


def trainable(params_np):
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("name", sorted(CONFS))
def test_loss_and_gradients_match_jax(name):
    conf = CONFS[name]
    _, _, model_j, model = build_both(conf)
    assert model.data_kind == model_j.data_kind
    params_np = numpy_params(model_j, 2)
    batch, w, epoch = make_batch(model, 3, epoch=2)
    with jax.enable_x64():
        b64 = {k: v.astype(jnp.float64) if v.dtype == jnp.float32 else v
               for k, v in jax_batch(batch, epoch).items()}
        want_loss, want_grads = jax.value_and_grad(model_j.loss)(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params_np), b64,
            jnp.asarray(w, jnp.float64))
        want_loss, want = float(want_loss), dict(param_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
    params = trainable(params_np)
    loss = model.loss(params, torch_batch(batch, epoch), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5, atol=1e-6)
    got = list(param_leaves(params))
    assert {path for path, _ in got} == set(want)
    for path, p in got:
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(grad, want[path], rtol=1e-5, atol=1e-6, err_msg=str(path))


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


@pytest.mark.parametrize("name", ["mlp-bpr", "neumf-ce", "apr-grad", "fism-square", "nais-prod", "deepicf-bn",
                                  "dmf-ce", "convncf"])
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


@pytest.mark.parametrize("name,d", [("apr-grad", 8), ("fism-square", 9)])
def test_factorized_models_feed_k1(name, d):
    """APR and FISM evaluate through ``eval_embeddings`` (K1); FISM's item
    bias rides in an extra column, so its scores equal ``predict``'s."""
    _, _, model_j, model = build_both(CONFS[name])
    params = params_from_numpy(numpy_params(model_j, 6), "cpu")
    users = torch.arange(0, 40, 4)
    with torch.no_grad():
        u, items = model.eval_embeddings(params, users)
        assert u.shape == (10, d) and items.shape == (model.num_items, d)
        np.testing.assert_allclose((u @ items.T).numpy(), model.predict(params, users).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_apr_random_perturbation():
    conf = dict(CONFS["apr-grad"], adv="random", adv_epoch=3)
    _, _, model_j, model = build_both(conf)
    params_np = numpy_params(model_j, 7)
    batch, w, _ = make_batch(model, 8)
    # before adv_epoch the random term is switched off: the JAX loss exactly
    want = jax.value_and_grad(model_j.loss)(jax.tree_util.tree_map(jnp.asarray, params_np),
                                            jax_batch(batch, 2), jnp.asarray(w))[0]
    tb = torch_batch(batch, 2)
    tb["generator"] = torch.Generator().manual_seed(0)
    got = model.loss(trainable(params_np), tb, torch.from_numpy(w))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    # the perturbation: rows of norm eps, the same for the same seed
    P, Q = (torch.from_numpy(params_np[k]) for k in ("embedding_P", "embedding_Q"))
    users, pos, neg = (torch.from_numpy(batch[k]).long() for k in ("users", "pos_items", "neg_items"))
    dP, dQ = model._deltas(P, Q, users, pos, neg, torch.from_numpy(w), torch.Generator().manual_seed(1))
    np.testing.assert_allclose(dP.norm(dim=1).numpy(), 0.5, rtol=1e-5)
    np.testing.assert_allclose(dQ.norm(dim=1).numpy(), 0.5, rtol=1e-5)
    again = model._deltas(P, Q, users, pos, neg, torch.from_numpy(w), torch.Generator().manual_seed(1))
    assert torch.equal(dP, again[0]) and torch.equal(dQ, again[1])
    tb["epoch"] = 3  # switched on: a draw is needed
    del tb["generator"]
    with pytest.raises(ValueError, match="generator"):
        model.loss(trainable(params_np), tb, torch.from_numpy(w))


def test_deepicf_batch_norm_statistics_are_per_user_in_predict():
    """``predict`` normalizes over one user's catalogue, never across the
    users of a batch: each row equals the row predicted alone and the JAX
    ``lax.map``'s, and statistics over the batch's users together would
    give other scores."""
    conf = CONFS["deepicf-bn"]
    _, _, model_j, model = build_both(conf)
    params_np = numpy_params(model_j, 9)
    params = params_from_numpy(params_np, "cpu")
    users = torch.tensor([2, 17, 30])
    with torch.no_grad():
        batch_rows = model.predict(params, users)
        alone = torch.cat([model.predict(params, users[i:i + 1]) for i in range(3)])
        capacity = model.predict_capacity(users.numpy()[None])
        p = torch.cat([p * model._coeff(users)[:, :, None]
                       for _, p, _ in model._attend_edges(params, users, capacity)], dim=1)  # (3, I, d)
        across_users = model._prob(params, p, params["Q"], torch.arange(model.num_items))
    np.testing.assert_allclose(batch_rows.numpy(), alone.numpy(), rtol=1e-6, atol=1e-7)
    want = np.asarray(model_j.predict(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users.numpy())))
    np.testing.assert_allclose(batch_rows.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(across_users.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["mlp-bpr", "neumf-ce", "convncf", "dmf-ce"])
def test_chunked_predict_matches_unchunked(name, monkeypatch):
    """The item (and user) chunks of ``predict`` leave the scores as they are."""
    _, _, model_j, model = build_both(CONFS[name])
    params = params_from_numpy(numpy_params(model_j, 10), "cpu")
    users = torch.arange(0, 40, 3)
    with torch.no_grad():
        whole = model.predict(params, users)
        if name == "convncf":
            from neurec_tpu_torch.models.general import convncf
            monkeypatch.setattr(convncf, "_PREDICT_CHUNK", 7)
            monkeypatch.setattr(convncf, "_PAIRS", 20)
        elif name == "dmf-ce":
            from neurec_tpu_torch.models.general import dmf
            monkeypatch.setattr(dmf, "_TRANSIENT", 16 * 40)
        else:
            model.predict_chunk = 7
        chunked = model.predict(params, users)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_nais_predict_over_item_chunks(monkeypatch):
    from neurec_tpu_torch.models.general import nais

    _, _, model_j, model = build_both(CONFS["nais-concat"])
    params = params_from_numpy(numpy_params(model_j, 11), "cpu")
    users = torch.tensor([1, 5, 9])
    with torch.no_grad():
        whole = model.predict(params, users)
        monkeypatch.setattr(nais, "_TRANSIENT", 300)
        chunked = model.predict(params, users)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_dmf_dense_eval_hook_follows_the_budget(monkeypatch):
    from neurec_tpu_torch.models.general.dmf import DMF

    _, ds, model_j, model = build_both(CONFS["dmf-ce"])
    assert callable(model.eval_dense_scores)
    params = params_from_numpy(numpy_params(model_j, 12), "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(model.eval_dense_scores(params)[[4, 8]].numpy(),
                                   model.predict(params, torch.tensor([4, 8])).numpy(), rtol=1e-6, atol=1e-7)
    monkeypatch.setattr(DMF, "_DENSE_EVAL_BUDGET", 16)
    small = get_model("DMF")(ds, DictConfig(CONFS["dmf-ce"]), device="cpu")
    assert small.eval_dense_scores is None


def test_convncf_conv_is_a_same_padded_stride2_conv():
    """The patch matmul equals ``lax.conv_general_dilated`` (NHWC, HWIO,
    stride 2, SAME) on an even map."""
    from neurec_tpu_torch.models.general.convncf import conv2x2_stride2

    rng = np.random.RandomState(13)
    x = rng.randn(5, 8, 8, 3).astype(np.float32)
    w = rng.randn(2, 2, 3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = conv2x2_stride2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_convncf_rejects_a_map_the_convs_do_not_reduce():
    ds = random_dataset(num_users=10, num_items=30, seed=0)
    with pytest.raises(ValueError, match="stride-2"):
        get_model("ConvNCF")(ds, DictConfig(dict(CONFS["convncf"], embedding_size=16)), device="cpu")
