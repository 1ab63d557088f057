"""The sequential models (FPMC, FPMCplus, TransRec, Fossil, HRM, NPE,
SASRec, Caser, GRU4Rec, GRU4RecPlus, SRGNN) against the JAX package's, on
the CPU.

Each model is built in both packages on the same ``random_dataset`` (with
times); the JAX ``init_params`` gives the tree, every leaf redrawn from
numpy U(-0.5, 0.5) and carried into the port by the bridge (SASRec's
``blocks``, Caser's ``conv_h`` and GRU4Rec's ``cells`` lists, SRGNN's
``gru`` dict). Then:

* one batch: the loss and every gradient against ``jax.value_and_grad``
  in float64, rtol 1e-10 / atol 1e-12. The time-order models take their
  ``loss``; the custom ones the loss of one step (SASRec's ``seq_loss``,
  Caser's ``caser_loss``, GRU4Rec's step on carried states with
  GRU4RecPlus's extra negatives, SRGNN's batch), with the JAX dropout masks
  rebuilt from the step key and handed to ``_bernoulli``. Fossil's f64
  check takes alpha 1: at 0.5 XLA's and torch's f32 ``pow`` differ by an
  ulp, in a coefficient both packages compute in f32;
* ``predict`` against the JAX ``predict`` to 1e-5, and ``eval_embeddings``
  (the factorized form K1 ranks) at its width, equal to ``predict`` and to
  the JAX factors;
* the ranked top-K ids of every user, train items masked, equal to
  ``lax.top_k``'s, ties included; the evaluation string equal to the JAX
  ``Evaluator``'s to 1e-6 a field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.models.sequential.gru4rec import _gru_step as jax_gru_step
from neurec_tpu.ops.losses import l2_loss as jax_l2_loss
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops.topk import top_k

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [5, 10], "metric": ["Recall", "NDCG"], "test_batch_size": 16}
CONFS = {
    "fpmc": dict(recommender="FPMC", embedding_size=8, reg_mf=0.01, is_pairwise=False, num_neg=2,
                 loss_function="cross_entropy", init_method="uniform"),
    "fpmc-pair": dict(recommender="FPMC", embedding_size=8, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "fpmcplus": dict(recommender="FPMCplus", embedding_size=8, weight_size=4, high_order=3, reg_mf=0.01,
                     reg_w=0.01, is_pairwise=True, loss_function="BPR"),
    "transrec": dict(recommender="TransRec", embedding_size=8, reg_mf=0.01, is_pairwise=True,
                     loss_function="bpr"),
    "fossil": dict(recommender="Fossil", embedding_size=8, alpha=0.5, regs=[0.01, 0.02, 0.03], high_order=2,
                   is_pairwise=False, num_neg=2, loss_function="cross_entropy"),
    "fossil-pair": dict(recommender="Fossil", embedding_size=8, alpha=0.5, regs=[0.01, 0.02, 0.03],
                        high_order=2, is_pairwise=True, loss_function="bpr"),
    "hrm": dict(recommender="HRM", embedding_size=8, reg_mf=0.01, high_order=2, pre_agg="max", session_agg="max",
                num_neg=2),
    "hrm-avg": dict(recommender="HRM", embedding_size=8, reg_mf=0.01, high_order=3, pre_agg="avg",
                    session_agg="avg", num_neg=2),
    "npe": dict(recommender="NPE", embedding_size=8, reg=0.01, high_order=3, num_neg=2),
    "sasrec": dict(recommender="SASRec", hidden_units=8, max_len=6, num_blocks=2, num_heads=2, dropout_rate=0.3,
                   l2_emb=0.01, lr=0.01),
    "caser": dict(recommender="Caser", factors_num=8, seq_L=3, seq_T=2, nv=2, nh=3, dropout=0.3, neg_samples=2,
                  l2_reg=0.01, lr=0.01),
    "gru4rec": dict(recommender="GRU4Rec", layers=[8], loss="top1", reg=0.01, lr=0.01),
    "gru4rec-bpr": dict(recommender="GRU4Rec", layers=[8, 6], loss="bpr", hidden_act="relu", reg=0.01, lr=0.01),
    "gru4recplus": dict(recommender="GRU4RecPlus", layers=[8], loss="bpr_max", bpr_reg=1.0, n_sample=12,
                        reg=0.01, lr=0.01),
    "gru4recplus-top1": dict(recommender="GRU4RecPlus", layers=[8], loss="top1_max", n_sample=12, lr=0.01),
    "srgnn": dict(recommender="SRGNN", hidden_size=8, max_seq_len=8, lr=0.01, lr_dc_step=1),
}
for _c in CONFS.values():
    _c.update(EVAL, batch_size=_c.get("batch_size", 8), learner="adam", learning_rate=0.01, epochs=1)
CONFS["gru4rec"]["batch_size"] = CONFS["gru4recplus"]["batch_size"] = 4

SIZE = (30, 40)
# factorized forms: (name, K1's width)
FACTORIZED = [("fpmc", 16), ("fossil", 9), ("hrm", 8), ("npe", 8), ("sasrec", 8), ("caser", 16), ("gru4rec", 9),
              ("gru4rec-bpr", 7), ("gru4recplus", 9)]
PREDICT_TIER = ["fpmcplus", "transrec", "srgnn"]


def build_both(conf, size=SIZE, seed=1):
    kw = dict(num_users=size[0], num_items=size[1], min_per_user=3, max_per_user=14, seed=seed)
    ds_j, ds = jax_random_dataset(**kw), random_dataset(**kw)
    model_j = jax_get_model(conf["recommender"])(ds_j, JaxDictConfig(conf))
    model = get_model(conf["recommender"])(ds, DictConfig(conf), device="cpu")
    return ds_j, ds, model_j, model


def numpy_params(model_j, seed, scale=0.5):
    """The JAX init's tree, every leaf redrawn from U(-scale, scale)."""
    tree = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32), tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else
                                  jnp.asarray(a), tree)


def inject(model, **draws):
    """Each call of ``model._<name>`` returns the next of ``draws[name]``."""
    for name, seq in draws.items():
        it = iter(seq)
        setattr(model, "_" + name, lambda *args, _it=it: next(_it))


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else (t if dtype is None else t.to(dtype))


def _time_batch(model, rng, B=24):
    users = rng.randint(0, model.num_users, B).astype(np.int32)
    batch = {"users": users,
             "recent_items": rng.randint(0, model.num_items, (B, model.high_order)).astype(np.int32)}
    if model.data_kind == "time_pairwise":
        batch["pos_items"] = rng.randint(0, model.num_items, B).astype(np.int32)
        batch["neg_items"] = rng.randint(0, model.num_items, B).astype(np.int32)
    else:
        batch["items"] = rng.randint(0, model.num_items, B).astype(np.int32)
        batch["labels"] = (rng.rand(B) < 0.4).astype(np.float64)
    return batch


def sasrec_masks(model_j, key, B, T_):
    """SASRec's dropout masks in the encoder's order (neurec_tpu/models/
    sequential/sasrec.py:138-166, ops/attention.py:46-52,79-83)."""
    keep, d, h = 1.0 - model_j.dropout_rate, model_j.hidden_units, model_j.num_heads
    r, rd = jax.random.split(key)
    masks = [jax.random.bernoulli(rd, keep, (B, T_, d))]
    for _ in range(model_j.num_blocks):
        r, r1, r2 = jax.random.split(r, 3)
        a1, a2 = jax.random.split(r2)
        masks += [jax.random.bernoulli(r1, keep, (B, h, T_, T_)), jax.random.bernoulli(a1, keep, (B, T_, d)),
                  jax.random.bernoulli(a2, keep, (B, T_, d))]
    return [T(m) for m in masks]


def jax_gru_loss(model_j, p, states, in_i, out_i, valid, extra):
    """The loss of one JAX GRU4Rec step (neurec_tpu/models/sequential/gru4rec.py:242-268)."""
    B = in_i.shape[0]
    y = out_i if extra is None else jnp.concatenate([out_i, extra])
    valid_cols = valid if extra is None else jnp.concatenate([valid, jnp.ones(extra.shape, valid.dtype)])
    x = p["input_emb"][in_i]
    h = x
    for cell, s in zip(p["cells"], states):
        h = jax_gru_step(cell, model_j.hidden_act, h, s)
    items_embed, items_bias = p["item_emb"][y], p["item_bias"][y]
    logits = model_j._final_act(h @ items_embed.T + items_bias)
    return model_j._loss_from_logits(logits, valid, valid_cols, B) + model_j.reg * jax_l2_loss(
        x * valid[:, None], items_embed * valid_cols[:, None], items_bias * valid_cols)


def loss_pair(name, model_j, model, params_np, seed=3):
    """(JAX loss fn of params, port loss fn of params) on one batch."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(11)
    kind = model.data_kind
    if kind.startswith("time_"):
        batch = _time_batch(model, rng)
        w = (rng.rand(len(batch["users"])) < 0.75).astype(np.float64)
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        bt = {k: T(v) for k, v in batch.items()}
        return (lambda p: model_j.loss(p, bj, jnp.asarray(w)), lambda p: model.loss(p, bt, T(w)))
    if name == "sasrec":
        n = int(model_j._seq.shape[0])
        idx = rng.randint(0, n, 8)
        seq, pos = np.asarray(model_j._seq)[idx], np.asarray(model_j._pos)[idx]
        neg = rng.randint(0, model.num_items, seq.shape).astype(np.int32)
        w = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float64)
        inject(model, bernoulli=sasrec_masks(model_j, key, *seq.shape))
        return (lambda p: model_j.seq_loss(p, jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w),
                                           key),
                lambda p: model.seq_loss(p, T(seq), T(pos), T(neg), T(w), torch.Generator()))
    if name == "caser":
        # two windows of short users, whose pre-padded targets hold num_items
        short = np.flatnonzero((np.asarray(model_j._poss) == model.num_items).any(axis=1))
        assert len(short) >= 2
        idx = np.concatenate([short[:2], rng.randint(0, int(model_j._users.shape[0]), 6)])
        users, seqs, pos = (np.asarray(a)[idx] for a in (model_j._users, model_j._seqs, model_j._poss))
        neg = rng.randint(0, model.num_items, (8, model.neg_samples)).astype(np.int32)
        w = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float64)
        out_dim = model.nv * model.d + model.nh * model.L
        inject(model, bernoulli=[T(jax.random.bernoulli(key, 1.0 - model.dropout, (8, out_dim)))])
        return (lambda p: model_j.caser_loss(p, jnp.asarray(users), jnp.asarray(seqs), jnp.asarray(pos),
                                             jnp.asarray(neg), jnp.asarray(w), key),
                lambda p: model.caser_loss(p, T(users), T(seqs), T(pos), T(neg), T(w), torch.Generator()))
    if name.startswith("gru4rec"):
        B = 6
        in_i, out_i = (rng.randint(0, model.num_items, B).astype(np.int32) for _ in range(2))
        valid = np.array([1, 1, 0, 1, 1, 0], np.float64)
        states = [rng.uniform(-0.5, 0.5, (B, n)) for n in model.layers]
        extra = (rng.randint(0, model.num_items, model.n_sample).astype(np.int32)
                 if model.name == "GRU4RecPlus" else None)
        ej = None if extra is None else jnp.asarray(extra)
        return (lambda p: jax_gru_loss(model_j, p, [jnp.asarray(s) for s in states], jnp.asarray(in_i),
                                       jnp.asarray(out_i), jnp.asarray(valid), ej),
                lambda p: model.step_loss(p, [T(s) for s in states], T(in_i), T(out_i), T(valid),
                                          None if extra is None else T(extra))[0])
    if name == "srgnn":
        idx = rng.randint(0, model._n_inst, 8)
        ij = jnp.asarray(idx)

        def jax_loss(p):
            logits = model_j._forward(p, model_j._seq[ij], model_j._seq_len[ij])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, model_j._tar[ij])
            return jnp.mean(ce) + model_j.L2 * sum(0.5 * jnp.sum(jnp.square(x)) for x in jax.tree.leaves(p))

        return jax_loss, lambda p: model.batch_loss(p, T(idx))
    raise KeyError(name)


LOSS_CASES = ["fpmc", "fpmc-pair", "fpmcplus", "transrec", "fossil", "fossil-pair", "hrm", "hrm-avg", "npe",
              "sasrec", "caser", "gru4rec", "gru4rec-bpr", "gru4recplus", "gru4recplus-top1", "srgnn"]
# see the module docstring: an exponent whose f32 pow both packages round alike
F64_OVERRIDES = {"fossil": {"alpha": 1.0}, "fossil-pair": {"alpha": 1.0}}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_and_gradients_match_jax_in_f64(name):
    conf = dict(CONFS[name], **F64_OVERRIDES.get(name, {}))
    _, _, model_j, model = build_both(conf)
    assert model.data_kind == model_j.data_kind
    params_np = numpy_params(model_j, 2)
    with jax.enable_x64():
        fn_j, fn = loss_pair(name, model_j, model, params_np)
        want_loss, want_grads = jax.jit(jax.value_and_grad(fn_j))(_f64(params_np))
        want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
    params = params_from_numpy(jax.tree_util.tree_map(lambda a: a.astype(np.float64), params_np), "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    loss = fn(params)
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-10, atol=1e-12)
    got = list(param_leaves(params))
    assert {path for path, _ in got} == set(want)
    for path, p in got:
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(grad, want[path], rtol=1e-10, atol=1e-12, err_msg=str(path))


ALL = sorted(CONFS)


@pytest.mark.parametrize("name", ALL)
def test_predict_matches_jax(name):
    _, _, model_j, model = build_both(CONFS[name])
    params_np = numpy_params(model_j, 4)
    users = np.array([0, 3, 7, 11, 29], dtype=np.int32)
    want = np.asarray(jax.jit(model_j.predict)(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users)))
    with torch.no_grad():
        got = model.predict(params_from_numpy(params_np, "cpu"), torch.from_numpy(users).long())
    assert got.shape == want.shape == (len(users), model.num_items)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,d", FACTORIZED)
def test_factorized_models_feed_k1(name, d):
    _, _, model_j, model = build_both(CONFS[name])
    params_np = numpy_params(model_j, 6)
    params = params_from_numpy(params_np, "cpu")
    users = torch.arange(0, 30, 3)
    with torch.no_grad():
        u, items = model.eval_embeddings(params, users)
        assert u.shape == (10, d) and items.shape == (model.num_items, d)
        np.testing.assert_allclose((u @ items.T).numpy(), model.predict(params, users).numpy(), rtol=1e-5,
                                   atol=1e-5)
    u_j, items_j = model_j.eval_embeddings(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users.numpy()))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=1e-5, atol=1e-6)


def test_predict_tier_models_have_no_factorized_form():
    for name in PREDICT_TIER:
        _, _, model_j, model = build_both(CONFS[name])
        assert getattr(model, "eval_embeddings", None) is None
        assert getattr(model_j, "eval_embeddings", None) is None
    _, _, model_j, model = build_both(dict(CONFS["gru4rec"], final_act="relu"))
    assert model.eval_embeddings is None and model_j.eval_embeddings is None


@pytest.mark.parametrize("name", ALL)
def test_top_k_ids_match_jax_ties_included(name):
    _, ds, model_j, model = build_both(CONFS[name])
    params_np = numpy_params(model_j, 8)
    users = np.arange(model.num_users, dtype=np.int32)
    scores_j = jax.jit(model_j.predict)(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(users))
    train = ds.train_matrix.toarray() > 0
    want = np.asarray(jax.lax.top_k(jnp.where(jnp.asarray(train), -jnp.inf, scores_j), 10)[1])
    with torch.no_grad():
        scores = model.predict(params_from_numpy(params_np, "cpu"), torch.from_numpy(users).long())
    got = top_k(torch.where(torch.from_numpy(train), float("-inf"), scores), 10)[1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ALL)
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
