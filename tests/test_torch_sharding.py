"""The port's sharded graph and data-parallel steps on gloo worlds, and the
port's mesh against the JAX package's.

* ``spmm_sharded`` (each 'data' rank's row block of the adjacency, its own
  K2 plans, the blocks all-gathered): A @ x and the gradient, summed over
  'data' as the trainer sums it, equal to the plain ``spmm`` within 1e-5,
  on (2, 1), (4, 1) and (2, 2); the segment-sum branch (a block without
  plans, as after NGCF's node dropout) equal to the plan branch.
* ``test_sharded_adjacency_matches_replicated`` (LightGCN, NGCF with
  ``graph_shard=on``): the propagated tables and one trained epoch (NGCF's
  params within 1e-4: its leaky ReLU kinks and row normalisation turn the
  split sums' f32 rounding into larger steps, as the JAX package's test
  notes of its own sharded run).
* ``test_batch_tensors_are_data_sharded``: the loss of each built-in epoch
  kind receives this rank's B / n rows.
* ``test_rest_of_the_zoo_sharded_matches_single``, and DiffNet on a seeded
  friendship file: every other model whose steps split, one epoch on
  (2, 1), equal to the single run.
* ``test_dp_constrain_warns_on_nondivisible_batch``: one warning on the
  primary rank, and the whole step on every rank gives the single run.
* ``test_item_shard_auto_engages_above_threshold``: with the score-block
  budget made small, ``auto`` takes ``item_shard_bits``.
* Against the JAX package: its (4, 2) mesh on 8 virtual CPU devices and the
  port's (2, 2) gloo world give equal metric strings on ``bits_dp`` and
  ``item_shard_bits`` for the same params, and the JAX ``spmm_sharded``
  (``NEUREC_PALLAS_INTERPRET=1``, as its own tests run it) the port's
  output and gradient within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.eval.evaluator import Evaluator as JaxEvaluator
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.ops import graph as jax_graph
from neurec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests import torch_mesh_worker as W

SHAPES = [(2, 1), (4, 1), (2, 2)]

torch.set_float32_matmul_precision("highest")


def _world(tmp_path_factory, shape, cases):
    return W.run_world(shape[0] * shape[1], shape[1], cases, str(tmp_path_factory.mktemp("w%dx%d" % shape)))


KINDS = {"pairwise": "LightGCN", "pointwise": "NeuMF", "time_pairwise": "FPMC", "dense_row": "MultiVAE"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for shape in SHAPES:
        cases = [("spmm", W.spmm_case, (), {}), ("segment", W.segment_branch_case, (), {})]
        cases += [("prop:" + n, W.propagate_case, (n,), {}) for n in ("LightGCN", "NGCF")]
        cases += [("kind:" + k, W.batch_shapes, (n,), {}) for k, n in KINDS.items()]
        if shape == (4, 1):
            cases += [("nondivisible", W.train, ("MF",), dict(epochs=1, batch_size=18)),
                      ("deepicf_bn", W.train, ("DeepICF",), dict(epochs=1))]
        if shape == (2, 2):
            cases += [("auto", W.item_shard_auto_case, (), {})]
        if shape == (2, 1):
            cases += [("zoo:" + n, W.train, (n,), dict(epochs=1)) for n in W.ZOO]
            cases += [("diffnet", W.diffnet_case, (str(tmp_path_factory.mktemp("diffnet")),), {})]
        out[shape] = _world(tmp_path_factory, shape, cases)
    return out


@pytest.fixture(scope="module")
def spmm_single():
    return W.spmm_case(None)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_spmm_sharded_matches_plain(worlds, spmm_single, shape):
    n_nodes = spmm_single["out"].shape[0]
    for res in worlds[shape]:
        got = res["spmm"]
        np.testing.assert_allclose(got["out"], spmm_single["out"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["grad"], spmm_single["grad"], rtol=0, atol=1e-5)
        # the block plans: block-local destination rows, the transposed plan's output every node
        assert got["block"] == got["plan_rows"] == -(-n_nodes // shape[0])
        assert got["plan_t_rows"] == n_nodes


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_segment_branch_matches_plan_branch(worlds, shape):
    for res in worlds[shape]:
        np.testing.assert_allclose(res["segment"]["segment"], res["segment"]["plan"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", ["LightGCN", "NGCF"])
def test_sharded_adjacency_matches_replicated(worlds, shape, name):
    want = W.propagate_case(None, name)
    assert not want["sharded"]
    for res in worlds[shape]:
        got = res["prop:" + name]
        assert got["sharded"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["table"], want["table"], rtol=0, atol=1e-5)
        a, b = W.leaves(got["params"]), W.leaves(want["params"])
        for path in a:
            np.testing.assert_allclose(a[path], b[path], rtol=0, atol=1e-4 if name == "NGCF" else 1e-5,
                                       err_msg=str(path))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batch_tensors_are_data_sharded(worlds, shape, kind):
    whole = W.batch_shapes(None, KINDS[kind])
    assert set(whole.values()) == {W.BATCH}
    for res in worlds[shape]:
        got = res["kind:" + kind]
        assert set(got) == set(whole)
        assert set(got.values()) == {W.BATCH // shape[0]}, got


def test_dp_constrain_warns_on_nondivisible_batch(worlds):
    want = W.train(None, "MF", epochs=1, batch_size=18)
    ranks = worlds[(4, 1)]
    warned = ranks[0]["nondivisible"]["warnings"]
    assert len(warned) == 1 and "does not divide the 'data' mesh axis (4)" in warned[0]
    for res in ranks:
        got = res["nondivisible"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        assert got["result"] == want["result"]
        a, b = W.leaves(got["params"]), W.leaves(want["params"])
        for path in a:
            np.testing.assert_allclose(a[path], b[path], rtol=0, atol=1e-6)
    assert all(res["nondivisible"]["warnings"] == [] for res in ranks[1:])  # the primary rank alone logs


@pytest.mark.parametrize("name", W.ZOO)
def test_rest_of_the_zoo_sharded_matches_single(worlds, name):
    """Every other model whose steps split, one epoch on (2, 1): the mean
    losses' weight count (MLP, NAIS, DeepICF, DMF, TransRec, Fossil, HRM,
    NPE), whole-tensor regularisers (NAIS, DeepICF, ConvNCF, MultiDAE,
    FPMCplus, TransRec, Fossil), batch-shaped dropout (ConvNCF, MultiDAE)
    and GRU4RecPlus's extra negative columns."""
    want = W.train(None, name, epochs=1)
    for res in worlds[(2, 1)]:
        got = res["zoo:" + name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["result"] == want["result"]
        a, b = W.leaves(got["params"]), W.leaves(want["params"])
        for path in a:
            np.testing.assert_allclose(a[path], b[path], rtol=0, atol=1e-5, err_msg=str(path))


def test_diffnet_sharded_matches_single(worlds, tmp_path):
    want = W.diffnet_case(None, str(tmp_path))
    for res in worlds[(2, 1)]:
        got = res["diffnet"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["result"] == want["result"]
        a, b = W.leaves(got["params"]), W.leaves(want["params"])
        for path in a:
            np.testing.assert_allclose(a[path], b[path], rtol=0, atol=1e-5, err_msg=str(path))


def test_batch_norm_step_runs_whole_on_every_rank(worlds):
    want = W.train(None, "DeepICF", epochs=1)
    for res in worlds[(4, 1)]:
        got = res["deepicf_bn"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        assert got["result"] == want["result"]


def test_item_shard_auto_engages_above_threshold(worlds):
    want = W.evaluate(None, "MF")
    for res in worlds[(2, 2)]:
        got = res["auto"]
        assert got["tier"] == "item_shard_bits"
        assert got["result"] == want["result"]
        np.testing.assert_array_equal(got["ids"][:got["n_users"]], want["ids"][:want["n_users"]])


# -- against the JAX package ---------------------------------------------------

def _jax_mf(params_np):
    ds = jax_random_dataset(num_users=40, num_items=48, min_per_user=4, max_per_user=12, seed=3)
    conf = JaxDictConfig(W.conf_dict("MF"))
    model = jax_get_model("MF")(ds, conf)
    mesh = jax_make_mesh(n_data=4, n_model=2)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params_np), model.param_shardings(mesh))
    return ds, conf, model, mesh, params


@pytest.fixture(scope="module")
def jax_vs_port(tmp_path_factory):
    params_np = W.train(None, "MF", epochs=1)["params"]
    cases = [("bits_dp", W.evaluate, ("MF",), dict(params_np=params_np)),
             ("item_shard_bits", W.evaluate, ("MF",), dict(params_np=params_np,
                                                            env={"NEUREC_EVAL_ITEM_SHARD": "1"})),
             ("spmm", W.spmm_case, (), {})]
    return params_np, _world(tmp_path_factory, (2, 2), cases)


@pytest.mark.parametrize("tier", ["bits_dp", "item_shard_bits"])
def test_jax_mesh_and_port_mesh_give_equal_metric_strings(jax_vs_port, monkeypatch, tier):
    params_np, ranks = jax_vs_port
    monkeypatch.setenv("NEUREC_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("NEUREC_EVAL_ITEM_SHARD", "1" if tier == "item_shard_bits" else "0")
    ds, conf, model, mesh, params = _jax_mf(params_np)
    ev = JaxEvaluator.from_dataset(ds, conf, mesh=mesh)
    assert ev.evaluator._get_steps(model.predict).plan.name == tier
    want = ev.evaluator.evaluate(model.predict, params)
    for res in ranks:
        assert res[tier]["tier"] == tier
        assert res[tier]["result"] == want


def test_spmm_sharded_matches_the_jax_package(jax_vs_port, monkeypatch):
    _, ranks = jax_vs_port
    monkeypatch.setenv("NEUREC_PALLAS_INTERPRET", "1")
    train = W.dataset().train_matrix
    adj = jax_graph.build_norm_adjacency(train, "pre")
    mesh = jax_make_mesh(n_data=4, n_model=2)
    sharded = jax_graph.shard_adjacency(adj, mesh)
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.standard_normal((adj.n_nodes, 8)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((adj.n_nodes, 8)).astype(np.float32))
    out = np.asarray(jax_graph.spmm_sharded(sharded, x, mesh))
    grad = np.asarray(jax.grad(lambda xx: jnp.sum(jax_graph.spmm_sharded(sharded, xx, mesh) * w))(x))
    for res in ranks:
        np.testing.assert_allclose(res["spmm"]["out"], out, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["spmm"]["grad"], grad, rtol=0, atol=1e-5)
