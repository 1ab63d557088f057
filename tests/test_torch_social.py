"""The social family (SBPR, DiffNet) against the JAX package's, on the CPU.

Both packages load the same rating and social files (the repo holds no
social file of its own, so they are written here, with duplicates,
self-loops, edges written both ways and ids outside the dataset).

* ``load_social_matrix``: the same CSR, numeric ids and text ids.
* SBPR's six host tables bit-equal to the JAX model's.
* SBPR's and DiffNet's loss and every gradient against JAX in float64 to
  rtol 1e-10 / atol 1e-12 (SBPR's loss is written inline in the JAX
  epoch, neurec_tpu/models/social/sbpr.py:127-142: the test transcribes it
  with the JAX package's own loss functions). DiffNet with and without an
  item feature file, keyed by numeric ids and by text ids.
* One epoch on the JAX epoch's own draws (SBPR's permutation, social slots
  and negatives, rebuilt from its key schedule, sbpr.py:114-150; DiffNet's
  pointwise draws, ``_jax_epoch_draws``): the epoch loss to rtol 2e-5, the
  params after it to atol 2e-5 (Adam magnifies f32 noise).
* ``_convert_distribution`` takes the population variance.
* ``predict``, ``eval_embeddings`` and ``eval_tables`` to rtol/atol 1e-5;
  the metric strings of a full evaluation to 1e-6, on factors with ties at
  the K-th place, and the top-K ids identical, ties included.
* ``run.main`` trains and evaluates each model for one epoch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.config import Config as JaxConfig
from neurec_tpu.data.dataset import Dataset as JaxDataset
from neurec_tpu.data.social import load_social_matrix as jax_load_social_matrix
from neurec_tpu.eval.evaluator import UniEvaluator as JaxUniEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.models.social.diffnet import _convert_distribution as jax_convert_distribution
from neurec_tpu.models.social.diffnet import _row_normalized_coo as jax_row_normalized_coo
from neurec_tpu.ops.losses import l2_loss as jax_l2_loss
from neurec_tpu.ops.losses import pairwise_loss as jax_pairwise_loss
from neurec_tpu.ops.sampling import sample_negatives as jax_sample_negatives
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.data.social import load_social_matrix
from neurec_tpu_torch.eval.evaluator import UniEvaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.social.diffnet import _convert_distribution, _row_normalized_coo
from neurec_tpu_torch.models.social.sbpr import social_tables
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_seq_models import T, inject
from tests.test_torch_training import SilentLogger, _jax_epoch_draws

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "NeuRec.properties")
N_USERS, N_ITEMS = 40, 50


def write_files(root, str_ids=False, seed=0):
    """A rating file (UIR, ',') and a social file over its users: 4 drawn
    friends a user (every 7th user none), then a duplicated edge, a
    self-loop, an edge both ways and edges to ids the dataset lacks."""
    rng = np.random.RandomState(seed)
    uid = (lambda u: "u%d" % u) if str_ids else str
    iid = (lambda i: "i%d" % i) if str_ids else str
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "soc.rating"), "w") as f:
        for u in range(N_USERS):
            for i in rng.choice(N_ITEMS, rng.randint(4, 14), replace=False):
                f.write("%s,%s,%d\n" % (uid(u), iid(i), rng.randint(1, 6)))
    lines = []
    for u in range(N_USERS):
        if u % 7 == 3:
            continue
        lines += ["%s,%s" % (uid(u), uid(v)) for v in rng.choice(N_USERS, 4, replace=False)]
    lines += ["%s,%s" % (uid(1), uid(2))] * 2 + ["%s,%s" % (uid(5), uid(5)),
                                                 "%s,%s" % (uid(8), uid(9)), "%s,%s" % (uid(9), uid(8)),
                                                 "%s,%s" % (uid(999), uid(1)), "%s,%s" % (uid(1), uid(998))]
    social = os.path.join(root, "soc.uu")
    with open(social, "w") as f:
        f.write("\n".join(lines) + "\n")
    return social


def feature_file(path, id_map, dim, seed=1):
    """``idx::::[v, ...]`` lines for every other known id, then an unknown id."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for key in list(id_map)[::2] + ["nobody"]:
            f.write("%s::::%s\n" % (key, [round(float(x), 4) for x in rng.randn(dim)]))
    return path


def configs(root, name, extra=()):
    def args(cache):
        return ["--recommender=%s" % name, "--config_dir=%s" % os.path.join(REPO, "conf"),
                "--data.input.path=%s" % root, "--data.cache.path=%s" % os.path.join(root, cache),
                "--data.input.dataset=soc", "--data.column.format=UIR", "--data.convert.separator=','",
                "--splitter=ratio", "--ratio=0.8", "--by_time=False", "--user_min=0", "--item_min=0",
                "--social_file=%s" % os.path.join(root, "soc.uu"), "--topk=[5]",
                "--metric=[\"Recall\",\"NDCG\",\"MRR\"]", "--test_batch_size=16"] + list(extra)

    return JaxConfig(LIB, cmd_args=args("jax")), Config(LIB, cmd_args=args("port"))


SBPR_ARGS = ["--embedding_size=8", "--batch_size=32", "--num_epochs=1", "--learning_rate=0.05"]
DIFFNET_ARGS = ["--embedding_size=8", "--batch_size=64", "--epochs=1", "--num_negatives=2",
                "--learning_rate=0.05", "--feature_dimension=6", "--user_feature_file=", "--item_feature_file="]


def build_both(root, name, extra=(), str_ids=False):
    write_files(root, str_ids)
    conf_j, conf = configs(root, name, extra)
    ds_j, ds = JaxDataset(conf_j), Dataset(conf)
    model_j = jax_get_model(name)(ds_j, conf_j)
    model = get_model(name)(ds, conf, device="cpu")
    return ds_j, ds, model_j, model, conf_j, conf


def numpy_params(model_j, seed, scale=0.3):
    tree = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32), tree)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def torch_f64(params_np):
    params = params_from_numpy(jax.tree_util.tree_map(lambda a: a.astype(np.float64), params_np), "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    return params


def assert_grads(params, loss, want_loss, want_grads):
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-10, atol=1e-12)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
    got = list(param_leaves(params))
    assert {path for path, _ in got} == set(want)
    for path, p in got:
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(grad, want[path], rtol=1e-10, atol=1e-12, err_msg=str(path))


@pytest.mark.parametrize("str_ids", [False, True], ids=["numeric-ids", "text-ids"])
def test_load_social_matrix_matches_jax(tmp_path, str_ids):
    root = str(tmp_path)
    write_files(root, str_ids)
    conf_j, conf = configs(root, "SBPR")
    ds_j, ds = JaxDataset(conf_j), Dataset(conf)
    assert ds.userids == ds_j.userids
    want, got = jax_load_social_matrix(ds_j, conf_j), load_social_matrix(ds, conf)
    assert got.shape == want.shape == (ds.num_users, ds.num_users) and got.dtype == want.dtype
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    key = (lambda u: "u%d" % u) if str_ids else (lambda u: u)
    ids = ds.userids
    assert got[ids[key(1)], ids[key(2)]] >= 2  # the duplicated edge sums
    assert got[ids[key(5)], ids[key(5)]] >= 1  # the self-loop stays
    assert got[ids[key(8)], ids[key(9)]] >= 1 and got[ids[key(9)], ids[key(8)]] >= 1
    # the edges to unknown ids are dropped: every kept line is counted once
    with open(os.path.join(root, "soc.uu")) as f:
        known = sum(all((int(t) if not str_ids else t) in ids for t in ln.split(","))
                    for ln in f.read().split())
    assert got.sum() == known


@pytest.mark.parametrize("str_ids", [False, True], ids=["numeric-ids", "text-ids"])
def test_sbpr_host_tables_are_the_jax_models(tmp_path, str_ids):
    _, ds, model_j, model, _, _ = build_both(str(tmp_path), "SBPR", SBPR_ARGS, str_ids)
    got = social_tables(ds.train_matrix, model.social_matrix)
    pairs = [(got.users_flat, model_j._users_flat, model._users_flat),
             (got.pos_flat, model_j._pos_flat, model._pos_flat),
             (got.items, model_j._social_items, model._social_items),
             (got.suk, model_j._social_suk, model._social_suk),
             (got.lengths, model_j._social_len, model._social_len),
             (got.excl, model_j._excl_rows, model._excl_rows)]
    for mine, theirs, on_device in pairs:
        theirs = np.asarray(theirs)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(on_device.numpy(), theirs)
    # users without social items keep a length of 1; some users have none
    assert (got.lengths == 1).any() and got.items.shape[1] == model.max_s > 1
    assert set(model.table_bytes) == {"soc", "suk", "excl"}


def jax_sbpr_loss(model_j, params, users, pos, soc, suk, negs, w):
    """The JAX epoch's step loss (neurec_tpu/models/social/sbpr.py:127-142)."""
    def score(items):
        q, b = params["item_emb"][items], params["bias"][items]
        return jnp.sum(params["user_emb"][users] * q, axis=-1) + b, q, b

    y_pos, q1, b1 = score(pos)
    y_soc, q2, b2 = score(soc)
    y_neg, q3, b3 = score(negs)
    u = params["user_emb"][users]
    w2 = w[:, None]
    return (jax_pairwise_loss(model_j.loss_function, (y_pos - y_soc) / suk, weights=w)
            + jax_pairwise_loss(model_j.loss_function, y_soc - y_neg, weights=w)
            + model_j.reg_mf * jax_l2_loss(u * w2, q2 * w2, q1 * w2, q3 * w2, b1 * w, b2 * w, b3 * w))


def test_sbpr_loss_and_gradients_match_jax_in_f64(tmp_path):
    _, ds, model_j, model, _, _ = build_both(str(tmp_path), "SBPR", SBPR_ARGS)
    tabs = social_tables(ds.train_matrix, model.social_matrix)
    rng = np.random.RandomState(3)
    idx = rng.randint(0, len(tabs.users_flat), 24)
    users, pos = tabs.users_flat[idx], tabs.pos_flat[idx]
    slot = rng.randint(0, 2 ** 30, 24) % tabs.lengths[users]
    soc, suk = tabs.items[users, slot], tabs.suk[users, slot].astype(np.float64)
    negs = rng.randint(0, model.num_items, 24).astype(np.int32)
    w = (rng.rand(24) < 0.75).astype(np.float64)
    params_np = numpy_params(model_j, 2)
    with jax.enable_x64():
        want_loss, want_grads = jax.value_and_grad(
            lambda p: jax_sbpr_loss(model_j, p, users, pos, soc, jnp.asarray(suk), negs, jnp.asarray(w)))(
            f64(params_np))
    params = torch_f64(params_np)
    loss = model.sbpr_loss(params, T(users), T(pos), T(soc), torch.from_numpy(suk), T(negs), torch.from_numpy(w))
    assert_grads(params, loss, want_loss, want_grads)


@pytest.mark.parametrize("features", [None, "numeric-ids", "text-ids"])
def test_diffnet_loss_and_gradients_match_jax_in_f64(tmp_path, features):
    root = str(tmp_path)
    extra = list(DIFFNET_ARGS)
    if features is not None:
        write_files(root, str_ids=features == "text-ids")
        conf_j, _ = configs(root, "DiffNet", extra)
        ids = JaxDataset(conf_j).itemids
        extra += ["--item_feature_file=%s" % feature_file(os.path.join(root, "items.vec"), ids, 6),
                  "--user_feature_file=%s" % os.path.join(root, "items.vec")]
    _, ds, model_j, model, _, _ = build_both(root, "DiffNet", extra, str_ids=features == "text-ids")
    assert model._has_item_feat == model_j._has_item_feat == (features is not None)
    np.testing.assert_array_equal(model._item_feat.numpy(), np.asarray(model_j._item_feat))
    for mine, theirs in ((_row_normalized_coo(model.social_matrix), model_j._soc_edges),
                         (_row_normalized_coo(ds.train_matrix), model_j._cons_edges)):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.RandomState(4)
    batch = {"users": rng.randint(0, model.num_users, 32).astype(np.int32),
             "items": rng.randint(0, model.num_items, 32).astype(np.int32),
             "labels": (rng.rand(32) < 0.4).astype(np.float64)}
    w = (rng.rand(32) < 0.75).astype(np.float64)
    params_np = numpy_params(model_j, 5)
    feat = np.asarray(model_j._item_feat)
    with jax.enable_x64():
        # the feature table in f64 too: its normalization runs in the
        # table's dtype, and f32 reductions of another order differ by ~1e-7
        model_j._item_feat = jnp.asarray(feat, jnp.float64)
        want_loss, want_grads = jax.value_and_grad(
            lambda p: model_j.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w)))(
            f64(params_np))
    model._item_feat = torch.from_numpy(feat.astype(np.float64))
    params = torch_f64(params_np)
    loss = model.loss(params, {k: T(v) for k, v in batch.items()}, torch.from_numpy(w))
    assert_grads(params, loss, want_loss, want_grads)


def test_row_normalized_coo_and_convert_distribution_match_jax():
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    m = sp.random(30, 30, density=0.2, random_state=rng, format="csr")
    m = (m + m.T).tocsr()
    for a, b in zip(_row_normalized_coo(m), jax_row_normalized_coo(m)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    x = rng.randn(50, 6).astype(np.float32) * 3 + 1
    got = _convert_distribution(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_convert_distribution(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    # the population variance (ddof 0), not torch's default unbiased one
    np.testing.assert_allclose(got, (x - x.mean()) * 0.1 / np.sqrt(x.var(ddof=0)), rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, (x - x.mean()) * 0.1 / np.sqrt(x.var(ddof=1)), rtol=1e-5, atol=1e-6)
    # a constant table clamps its variance at 1e-12
    np.testing.assert_array_equal(_convert_distribution(torch.ones(4, 3)).numpy(), np.zeros((4, 3), np.float32))


def jax_sbpr_epoch_draws(jt, model_j, epoch):
    """SBPR's JAX epoch's draws (neurec_tpu/models/social/sbpr.py:114-150):
    split(key) -> (perm key, step keys), each step key -> (slot, negatives)."""
    B = model_j.batch_size
    N = int(model_j._users_flat.shape[0])
    steps = -(-N // B)
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    idx = jnp.where(perm < N, perm, 0).reshape(steps, B)
    slots, negs = [], []
    for s, key in enumerate(jax.random.split(kn, steps)):
        k_soc, k_neg = jax.random.split(key)
        users = model_j._users_flat[idx[s]]
        slots.append(T(jax.random.randint(k_soc, (B,), 0, 2 ** 30)).long())
        negs.append(T(jax_sample_negatives(k_neg, model_j._excl_rows[users], model_j.num_items, ())).long())
    return ekey, [T(perm).long()], slots, negs


def test_sbpr_epoch_with_injected_jax_draws_matches_jax(tmp_path):
    ds_j, ds, model_j, model, conf_j, conf = build_both(str(tmp_path), "SBPR", SBPR_ARGS)
    jt = JaxTrainer(model_j, ds_j, conf_j, logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), seed=7, device="cpu")
    trainer.initialize()
    params_np = numpy_params(model_j, 5)
    ekey, perm, slots, negs = jax_sbpr_epoch_draws(jt, model_j, 2)
    assert len(slots) > 1
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(2))
    inject(model, perm=perm, social_slot=slots, negatives=negs)
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    params, _, loss = trainer._epoch_fn(params, trainer.init_opt_state(params), torch.Generator(), 2)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))
        assert not np.allclose(p, dict(param_leaves(params_np))[path])


def test_diffnet_epoch_with_injected_jax_draws_matches_jax(tmp_path):
    ds_j, ds, model_j, model, conf_j, conf = build_both(str(tmp_path), "DiffNet", DIFFNET_ARGS)
    jt = JaxTrainer(model_j, ds_j, conf_j, logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), seed=7, device="cpu")
    assert trainer.steps > 1
    params_np = numpy_params(model_j, 6)
    ekey, inst, w, negs = _jax_epoch_draws(jt, epoch=3)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(3))
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    params, _, loss = trainer.run_epoch(params, trainer.init_opt_state(params), torch.from_numpy(inst),
                                        torch.from_numpy(w), torch.from_numpy(negs), epoch=3)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))


def tied(params_np, name):
    """Factors with ties at the K-th place: items 0-9 share one vector."""
    params_np = jax.tree_util.tree_map(np.copy, params_np)
    params_np["item_emb"][1:10] = params_np["item_emb"][0]
    if name == "DiffNet":
        params_np["user_emb"][:] = np.abs(params_np["user_emb"])
    return params_np


@pytest.mark.parametrize("name,extra", [("SBPR", SBPR_ARGS), ("DiffNet", DIFFNET_ARGS)])
def test_predict_tables_and_metrics_match_jax(tmp_path, name, extra):
    ds_j, ds, model_j, model, _, _ = build_both(str(tmp_path), name, extra)
    params_np = tied(numpy_params(model_j, 8), name)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params = params_from_numpy(params_np, "cpu")
    users = np.arange(0, model.num_users, 3, dtype=np.int32)
    with torch.no_grad():
        got = model.predict(params, T(users))
        u, items = model.eval_embeddings(params, T(users))
    want = np.asarray(model_j.predict(params_j, jnp.asarray(users)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    u_j, items_j = model_j.eval_embeddings(params_j, jnp.asarray(users))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=1e-5, atol=1e-6)
    if name == "DiffNet":
        with torch.no_grad():
            for a, b in zip(model.eval_tables(params), model_j.eval_tables(params_j)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # the whole evaluation: the metric strings, and the top-K ids with ties
    kw = dict(metric=["Recall", "NDCG", "MRR"], top_k=[5], batch_size=16, num_items=ds.num_items)
    ev_j = JaxUniEvaluator(ds_j.get_user_train_dict(), ds_j.get_user_test_dict(), **kw)
    ev = UniEvaluator(ds.get_user_train_dict(), ds.get_user_test_dict(), device="cpu", **kw)
    got_s, want_s = ev.evaluate(model.predict, params), ev_j.evaluate(model_j.predict, params_j)
    assert len(got_s.split("\t")) == len(want_s.split("\t"))
    np.testing.assert_allclose([float(x) for x in got_s.split("\t")], [float(x) for x in want_s.split("\t")],
                               atol=1e-6)
    prog = ev._get_program(model.predict)
    assert prog.plan.name == "bits" and prog.plan.kind == "factorized"
    assert (prog.tables_fn is not None) == (name == "DiffNet")
    test_users = ev.test_users[:16]
    bits = ev._get_bits_table(prog.plan.pack_block, prog.plan.bits_width)[:16]
    with torch.no_grad():
        u_t, items_t = model.eval_embeddings(params, torch.from_numpy(test_users).long())
        ids = prog.fact_topk(u_t, items_t, bits).numpy()
    scores_j = np.array(model_j.predict(params_j, jnp.asarray(test_users)))
    for r, user in enumerate(test_users):
        scores_j[r, ds_j.get_user_train_dict().get(int(user), [])] = -np.inf
    want_ids = np.asarray(jax.lax.top_k(jnp.asarray(scores_j), 5)[1])
    np.testing.assert_array_equal(ids, want_ids)
    assert (np.isin(ids, np.arange(10)).sum(axis=1) > 1).any()  # the tied items reach the top-K


@pytest.mark.parametrize("name,extra", [("SBPR", ["--embedding_size=8", "--num_epochs=1"]),
                                        ("DiffNet", ["--embedding_size=8", "--epochs=1", "--num_negatives=2",
                                                     "--feature_dimension=6", "--user_feature_file=",
                                                     "--item_feature_file="])])
def test_run_main_trains_and_evaluates(tmp_path, monkeypatch, name, extra):
    from neurec_tpu_torch import run

    monkeypatch.chdir(tmp_path)  # the run logger writes under ./log
    root = str(tmp_path / "data")
    write_files(root)
    args = ["--recommender=%s" % name, "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--data.input.path=%s" % root, "--data.cache.path=%s" % os.path.join(root, "cache"),
            "--data.input.dataset=soc", "--data.column.format=UIR", "--data.convert.separator=','",
            "--social_file=%s" % os.path.join(root, "soc.uu"), "--batch_size=32", "--topk=[5]",
            "--metric=[\"Recall\",\"NDCG\"]"] + extra
    trainer, result = run.main(LIB, args, device="cpu")
    values = [float(x) for x in result.split("\t")]
    assert len(values) == 2 and all(0.0 <= v <= 1.0 for v in values)
    records = list((tmp_path / "log" / "soc" / name).glob("*.log.metrics.jsonl"))
    assert len(records) == 1 and np.isfinite(float(records[0].read_text().splitlines()[0].split('"loss": ')[1]
                                                   .split(",")[0]))
