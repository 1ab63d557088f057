"""NGCF in the port against the JAX package's, on the CPU.

* Params cross the bridge both ways with their per-layer lists.
* ``propagate``, the loss and every parameter gradient agree with the JAX
  model for the three ``alg_type``s at ``mess_dropout_ratio=0``, on the
  dense adjacency and on the same graph given plans (the port's plan
  branch, ``PlanSpmm``; ``norm`` is not symmetric, so the backward runs over
  a plan of its own; JAX takes its segment-sum). Tables and loss to rtol
  1e-5 / atol 1e-6; gradients to rtol 1e-5 plus 1e-5 of the largest entry
  of their array: a weight or bias gradient is a sum over every node that
  cancels, and both packages' f32 gradients lie up to ~2e-6 of that scale
  from a float64 run's.
* Message dropout keeps its share of entries, scaled by 1/keep, only while
  training; node dropout leaves the plans for the segment-sum path.
* The evaluator's metric strings agree to 1e-6 and the top-K ids are
  identical.
* One epoch fed the JAX epoch's own draws gives the JAX loss and params.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.ops.initializers import get_initializer as jax_get_initializer
from neurec_tpu.pretrain import save_pretrain
from neurec_tpu.recommend import batch_topk as jax_batch_topk
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import graph, spmm
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.recommend import batch_topk
from neurec_tpu_torch.trainer import Trainer

torch.set_float32_matmul_precision("highest")

CONF = dict(recommender="NGCF", embedding_size=8, layer_size=[8, 6, 4], reg=0.01, learning_rate=0.05,
            batch_size=128, learner="adam", adj_type="norm", alg_type="ngcf", mess_dropout_ratio=0.0,
            node_dropout_flag=False, topk=[5, 10], metric=["Recall", "NDCG", "MRR"], test_batch_size=64)


class SilentLogger:
    def info(self, msg):
        pass

    debug = warning = error = critical = info


def _both(conf, num_users=64, num_items=128, seed=0):
    ds_j = jax_random_dataset(num_users=num_users, num_items=num_items, seed=seed)
    ds = random_dataset(num_users=num_users, num_items=num_items, seed=seed)
    model_j = jax_get_model("NGCF")(ds_j, JaxDictConfig(conf))
    model = get_model("NGCF")(ds, DictConfig(conf), device="cpu")
    return ds_j, ds, model_j, model


def _numpy_params(model, seed):
    """NGCF-shaped params from numpy, lists per layer, scaled as its init."""
    rng = np.random.RandomState(seed)
    dims = [model.emb_dim] + model.weight_size
    params = {"user_emb": rng.uniform(-0.3, 0.3, (model.num_users, model.emb_dim)).astype(np.float32),
              "item_emb": rng.uniform(-0.3, 0.3, (model.num_items, model.emb_dim)).astype(np.float32)}
    for name in ("W_gc", "b_gc", "W_bi", "b_bi", "W_mlp", "b_mlp"):
        params[name] = [
            (rng.standard_normal((1 if name.startswith("b") else dims[k], dims[k + 1]))
             * (0.1 if name.startswith("b") else 1.0 / np.sqrt(dims[k]))).astype(np.float32)
            for k in range(model.n_layers)
        ]
    return params


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _batch(model, seed, B=96):
    rng = np.random.RandomState(seed)
    return ({"users": rng.randint(0, model.num_users, B).astype(np.int32),
             "pos_items": rng.randint(0, model.num_items, B).astype(np.int32),
             "neg_items": rng.randint(0, model.num_items, B).astype(np.int32)},
            (rng.rand(B) < 0.75).astype(np.float32))


def test_params_cross_the_bridge_both_ways():
    _, _, model_j, model = _both(CONF)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    assert isinstance(params["W_gc"], list) and len(params["W_gc"]) == 3
    back = params_to_numpy(params)
    for (path, a), (_, b) in zip(param_leaves(back), param_leaves(jax.tree_util.tree_map(np.asarray, params_j))):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # and the port's own init goes the other way, into the JAX model's loss
    mine = model.init_params(torch.Generator().manual_seed(0))
    batch, w = _batch(model, 1)
    loss = model_j.loss(_jax(params_to_numpy(mine)), _jax(batch), jnp.asarray(w))
    assert np.isfinite(float(loss))


def test_xavier_normal_fans_match_jax_on_bias_rows():
    """(1, d) biases: fan_in 1, fan_out d in both packages."""
    shape = (1, 40000)
    got = get_initializer("xavier_normal")(torch.Generator().manual_seed(0), shape).numpy()
    want = np.asarray(jax_get_initializer("xavier_normal")(jax.random.PRNGKey(0), shape))
    std = np.sqrt(2.0 / (1 + shape[1]))
    assert abs(got.std() / std - 1) < 0.02 and abs(want.std() / std - 1) < 0.02


def _onto_plans(model, model_j, tile_r=32, chunk=16):
    """The same adjacency with the plans of A and A^T instead of the dense
    copy (the port's plan branch; the JAX package takes its segment-sum)."""
    adj = model.adj
    coo = (adj.rows.numpy(), adj.cols.numpy(), adj.vals.numpy())
    plan = spmm.build_spmm_plan(*coo, adj.n_nodes, tile_r=tile_r, chunk=chunk)
    plan_t = spmm.build_spmm_plan(coo[1], coo[0], coo[2], adj.n_nodes, tile_r=tile_r, chunk=chunk)
    model.adj = adj._replace(dense=None, plan=plan.to("cpu"), plan_t=plan_t._replace(transposed=True).to("cpu"))
    model_j.adj = model_j.adj._replace(dense=None)


@pytest.mark.parametrize("alg_type", ["ngcf", "gcn", "gcmc"])
@pytest.mark.parametrize("branch", ["dense", "plan"])
def test_propagate_loss_and_gradients_match_jax(alg_type, branch):
    # gcmc's W_mlp maps a layer's input width to its output width: equal widths only
    conf = dict(CONF, alg_type=alg_type, layer_size=[8, 8, 8] if alg_type == "gcmc" else [8, 6, 4])
    _, _, model_j, model = _both(conf, seed=1)
    if branch == "plan":
        _onto_plans(model, model_j)
        assert not np.allclose(model.adj.plan.vals.numpy(), model.adj.plan_t.vals.numpy())
    params_np = _numpy_params(model, 2)
    u_j, i_j = model_j.propagate(_jax(params_np))
    u, i = model.propagate(params_from_numpy(params_np, "cpu"))
    width = sum(model.weight_size) + (0 if alg_type == "gcmc" else model.emb_dim)
    assert u.shape == (model.num_users, width)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i.numpy(), np.asarray(i_j), rtol=1e-5, atol=1e-6)

    batch, w = _batch(model, 3)
    want_loss, want_grads = jax.value_and_grad(model_j.loss)(_jax(params_np), _jax(batch), jnp.asarray(w))
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    model.loss(params, tb, torch.from_numpy(w)).backward()
    np.testing.assert_allclose(float(model.loss(params, tb, torch.from_numpy(w)).detach()), float(want_loss),
                               rtol=1e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, want_grads)))
    for path, p in param_leaves(params):
        g = np.zeros_like(want[path]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, want[path], rtol=1e-5, atol=1e-5 * np.abs(want[path]).max(),
                                   err_msg=str(path))


def test_message_dropout_keeps_its_share_scaled_while_training():
    conf = dict(CONF, mess_dropout_ratio=0.3)
    _, _, _, model = _both(conf)
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(3)
    out = model._mess_dropout(x, gen, training=True)
    kept = out != 0
    share, n = float(kept.float().mean()), x.numel()
    assert abs(share - 0.7) < 4 * np.sqrt(0.7 * 0.3 / n)
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(out, model._mess_dropout(x, torch.Generator().manual_seed(3), training=True))
    assert model._mess_dropout(x, gen, training=False) is x
    assert model._mess_dropout(x, None, training=True) is x


def test_loss_draws_dropout_from_the_step_generator():
    conf = dict(CONF, mess_dropout_ratio=0.2)
    _, _, _, model = _both(conf)
    params = params_from_numpy(_numpy_params(model, 4), "cpu")
    batch, w = _batch(model, 5)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    w = torch.from_numpy(w)

    def loss(seed):
        return float(model.loss(params, dict(tb, generator=torch.Generator().manual_seed(seed)), w))

    assert loss(1) == loss(1) and loss(1) != loss(2)
    assert float(model.loss(params, tb, w)) == float(model.loss(dict(params), tb, w))  # none: no dropout


def test_node_dropout_leaves_the_plans_for_the_segment_sum():
    conf = dict(CONF, node_dropout_flag=True, node_dropout_ratio=0.25)
    _, ds, _, model = _both(conf, 6000, 3000, seed=6)
    assert model.adj.plan is not None
    adj = model._adj_for_step(torch.Generator().manual_seed(0), training=True)
    assert adj.plan is None and adj.plan_t is None and adj.dense is None
    real = model.adj.vals != 0
    kept = (adj.vals != 0) & real
    share, n = float(kept.sum()) / float(real.sum()), int(real.sum())
    assert abs(share - 0.75) < 4 * np.sqrt(0.75 * 0.25 / n)
    np.testing.assert_allclose(adj.vals[kept].numpy(), model.adj.vals[kept].numpy() / 0.75, rtol=1e-6)
    assert model._adj_for_step(torch.Generator().manual_seed(0), training=False) is model.adj
    x = torch.randn(model.adj.n_nodes, 4, generator=torch.Generator().manual_seed(1))
    dense = torch.zeros(adj.n_nodes, adj.n_nodes).index_put_((adj.rows.long(), adj.cols.long()), adj.vals,
                                                             accumulate=True)
    np.testing.assert_allclose(graph.spmm(adj, x).numpy(), (dense @ x).numpy(), rtol=1e-5, atol=1e-5)


def test_evaluator_and_topk_match_jax():
    conf = dict(CONF, alg_type="ngcf")
    ds_j, ds, model_j, model = _both(conf, 300, 500, seed=7)
    params_np = _numpy_params(model, 8)
    params_j, params = _jax(params_np), params_from_numpy(params_np, "cpu")
    ev_j = JaxEvaluator.from_dataset(ds_j, JaxDictConfig(conf))
    ev = Evaluator.from_dataset(ds, DictConfig(conf), device="cpu")
    s_j, s = ev_j.evaluate(model_j.predict, params_j), ev.evaluate(model.predict, params)
    fields_j, fields = s_j.split("\t"), s.split("\t")
    assert ev.metrics_info() == ev_j.metrics_info() and len(fields) == len(fields_j) == 6
    assert [len(f) for f in fields] == [len(f) for f in fields_j]
    np.testing.assert_allclose([float(f) for f in fields], [float(f) for f in fields_j], atol=1e-6)
    users = np.arange(0, 300, 3, dtype=np.int32)
    items_j, _ = jax_batch_topk(model_j, params_j, 10, users=users, train_matrix=ds_j.train_matrix)
    items, _ = batch_topk(model, params, 10, users=users, train_matrix=ds.train_matrix, device="cpu")
    np.testing.assert_array_equal(items, np.asarray(items_j))


def test_pretrain_file_warm_starts_the_embeddings(tmp_path, monkeypatch):
    from neurec_tpu_torch import pretrain

    said = []
    monkeypatch.setattr(pretrain.log, "info", said.append)
    rng = np.random.RandomState(9)
    mf = {"user_emb": rng.randn(64, 8).astype(np.float32), "item_emb": rng.randn(128, 8).astype(np.float32)}
    path = str(tmp_path / "mf.pkl")
    save_pretrain("MF", mf, path)  # the JAX package's writer
    _, _, _, model = _both(dict(CONF, pretrain_file=path))
    params = model.init_params(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(params["user_emb"].numpy(), mf["user_emb"])
    np.testing.assert_array_equal(params["item_emb"].numpy(), mf["item_emb"])
    assert said[-1].startswith("load pretrained params successful!")
    with open(path, "wb") as fout:
        fout.write(pickle.dumps([1])[:3])  # truncated
    _, _, _, model = _both(dict(CONF, pretrain_file=path))
    assert model.init_params(torch.Generator().manual_seed(0))["user_emb"].shape == (64, 8)
    assert said[-1].startswith("load pretrained params unsuccessful!")


def test_epoch_with_injected_jax_draws_matches_jax():
    from tests.test_torch_training import _jax_epoch_draws

    ds_j, ds, model_j, model = _both(CONF, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(CONF), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(CONF), logger=SilentLogger(), seed=7, device="cpu")
    params_np = _numpy_params(model, 5)
    ekey, inst, w, negs = _jax_epoch_draws(jt, epoch=2)
    params_j = _jax(params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(2))

    params = params_from_numpy(params_np, "cpu")
    leaves = [p.requires_grad_(True) for _, p in param_leaves(params)]
    params, _, loss = trainer.run_epoch(params, trainer.tx(leaves), torch.from_numpy(inst),
                                        torch.from_numpy(w), torch.from_numpy(negs))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    start = dict(param_leaves(params_np))
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))
    assert not np.allclose(params_to_numpy(params)["user_emb"], start[("user_emb",)])


def test_ngcf_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = random_dataset(num_users=20, num_items=30, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("NGCF")(ds, DictConfig(CONF))
    assert get_model("NGCF")(ds, DictConfig(CONF), device="cpu").adj.dense.device.type == "cpu"
