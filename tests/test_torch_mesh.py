"""The port's mesh on torch.distributed, held to its own single-device run.

Gloo worlds of CPU processes (``tests/torch_mesh_worker.py``) on a (2, 1),
(4, 1) and (2, 2) ('data', 'model') mesh train one model of every epoch
family, and APR, CDAE and DAE for the loss terms that are not sums over the
batch's rows, then evaluate on the mesh tiers. Each is held to the same
code without a mesh, as ``tests/test_sharding.py`` holds the JAX package's
sharded run to its single run:

* every rank's epoch losses within rtol 1e-5 and its params within 1e-5
  (GRU4Rec 1e-4: its states carry the f32 rounding of the split sums over
  the epoch's steps; SASRec's attention key biases are left out: a key
  bias adds one constant to a query's logits, which the softmax cancels,
  so its true gradient is zero and Adam turns rounding into steps of the
  learning rate's size), and its metric string equal character for
  character;
* the mesh tiers (``bits_dp``, ``pallas_dp``, the streamed table, the
  grouped evaluator, the item-sharded tiers with premask auto and 0):
  the tier taken, the metric string, and the top-K ids of every real slot;
* a checkpoint written at (2, 1) resumed at (1, 1), and the other way round,
  equal to the uninterrupted run;
* the multi-device settings read and checked as the JAX package reads
  them: ``eval_item_shard``, ``NEUREC_EVAL_ITEM_SHARD``,
  ``mesh.model_axis``, ``graph_shard``.
"""

import logging
import os
import types

import numpy as np
import pytest
import torch

from neurec_tpu_torch.parallel import distributed
from neurec_tpu_torch.parallel.mesh import (
    Placement, batch_split, batch_sum, global_device_put, make_mesh, shard_params, split_draw, whole_term,
)
from tests import torch_mesh_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 1), (4, 1), (2, 2)]
PARAM_ATOL = {"GRU4Rec": 1e-4}
EVAL_CASES = {
    "bits_dp": ("MF", {}, None),
    "pallas_dp": ("MF", {"NEUREC_EVAL_PREMASK": "0"}, None),
    "stream": ("MF", {"NEUREC_EVAL_BITS_BUDGET": "1"}, None),
    "lightgcn": ("LightGCN", {}, None),
    "grouped": ("MF", {}, [4, 8, 12]),
}
ITEM_SHARD_CASES = {
    "item_shard_bits": {"NEUREC_EVAL_ITEM_SHARD": "1"},
    "item_shard_rows": {"NEUREC_EVAL_ITEM_SHARD": "1", "NEUREC_EVAL_PREMASK": "0"},
    "item_shard_stream": {"NEUREC_EVAL_ITEM_SHARD": "1", "NEUREC_EVAL_BITS_BUDGET": "1"},
}
WANT_TIER = {"bits_dp": "bits_dp", "pallas_dp": "pallas_dp", "stream": "bits_dp", "lightgcn": "bits_dp",
             "item_shard_bits": "item_shard_bits", "item_shard_rows": "item_shard_rows",
             "item_shard_stream": "item_shard_bits"}

torch.set_float32_matmul_precision("highest")


def _world_cases(shape):
    cases = [("train:" + n, W.train, (n,), {}) for n in W.FAMILIES]
    cases += [("eval:" + k, W.evaluate, (n,), dict(env=env, group_view=g)) for k, (n, env, g) in EVAL_CASES.items()]
    if shape[1] > 1:
        cases += [("eval:" + k, W.evaluate, ("MF",), dict(env=env)) for k, env in ITEM_SHARD_CASES.items()]
    cases += [("native", W.native_refused, (), {})]
    cases += [("graph_shard:" + m, W.graph_sharded, (m,), {}) for m in ("off", "auto", "on")]
    return cases


@pytest.fixture(scope="module")
def single():
    out = {"train:" + n: W.train(None, n) for n in W.FAMILIES}
    out.update({"eval:" + k: W.evaluate(None, n, env=env, group_view=g) for k, (n, env, g) in EVAL_CASES.items()})
    # the replicated tier is the item-sharded tiers' reference
    out.update({"eval:" + k: out["eval:bits_dp"] for k in ITEM_SHARD_CASES})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {shape: W.run_world(shape[0] * shape[1], shape[1], _world_cases(shape),
                               str(tmp_path_factory.mktemp("world%dx%d" % shape)))
            for shape in SHAPES}


def _assert_params_close(got, want, atol, exempt=()):
    got, want = W.leaves(got), W.leaves(want)
    assert set(got) == set(want)
    for path in got:
        if not any(path[-len(e):] == e for e in exempt):
            np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", W.FAMILIES)
def test_every_epoch_family_sharded_matches_single(worlds, single, shape, name):
    want = single["train:" + name]
    exempt = (("att", "k", "b"),) if name == "SASRec" else ()
    for rank, res in enumerate(worlds[shape]):
        got = res["train:" + name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, err_msg="rank %d" % rank)
        _assert_params_close(got["params"], want["params"], PARAM_ATOL.get(name, 1e-5), exempt)
        assert got["result"] == want["result"], "rank %d" % rank
        assert got["warnings"] == []
    # LightGCN's configuration shards its graph (graph_shard=on) on every mesh
    assert worlds[shape][0]["train:" + name]["sharded"] == (name == "LightGCN")


# the item-sharded tiers need a 'model' axis above one
EVAL_PARAMS = [(shape, case) for shape in SHAPES for case in sorted(EVAL_CASES)] + [
    (shape, case) for shape in SHAPES if shape[1] > 1 for case in sorted(ITEM_SHARD_CASES)]


@pytest.mark.parametrize("shape, case", EVAL_PARAMS, ids=lambda v: "%dx%d" % v if isinstance(v, tuple) else v)
def test_sharded_eval_matches_single_device(worlds, single, shape, case):
    want = single["eval:" + case]
    for rank, res in enumerate(worlds[shape]):
        got = res["eval:" + case]
        assert got["result"] == want["result"], "rank %d" % rank
        if case == "grouped":
            continue
        assert got["tier"] == WANT_TIER[case]
        np.testing.assert_allclose(got["raw"], want["raw"], rtol=0, atol=1e-6)
        # the ids of every real slot (a pad slot of the last batch packs no
        # pair on the streamed tiers)
        n = got["n_users"]
        np.testing.assert_array_equal(got["ids"][:n], want["ids"][:n], err_msg="rank %d" % rank)


def test_single_tiers_are_the_replicated_ones(single):
    assert single["eval:bits_dp"]["tier"] == "bits"
    assert single["eval:pallas_dp"]["tier"] == "pallas"
    assert single["eval:stream"]["tier"] == "bits"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_native_backend_is_single_process_only(worlds, shape):
    assert all(res["native"] for res in worlds[shape])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_graph_shard_setting(worlds, shape):
    """graph_shard=off keeps the adjacency whole; auto shards only a graph
    above the dense limit (this one is below it); on shards."""
    for res in worlds[shape]:
        assert (res["graph_shard:off"], res["graph_shard:auto"], res["graph_shard:on"]) == (False, False, True)


# -- checkpoints across mesh shapes --------------------------------------------

@pytest.mark.parametrize("first, second", [((2, 1), (1, 1)), ((1, 1), (2, 1))], ids=["2x1_to_1x1", "1x1_to_2x1"])
def test_checkpoint_resumes_on_another_mesh_shape(tmp_path, first, second):
    whole = W.checkpoint_case(None, str(tmp_path / "whole"), 2)
    ckpt = str(tmp_path / "ckpt")
    a = W.run_world(first[0] * first[1], first[1], [("c", W.checkpoint_case, (ckpt, 1), {})], str(tmp_path / "a"))
    assert sorted(os.listdir(ckpt)) == ["ckpt-1.pt"]  # the primary rank alone wrote
    b = W.run_world(second[0] * second[1], second[1], [("c", W.checkpoint_case, (ckpt, 2), {})], str(tmp_path / "b"))
    for res in a + b:
        assert res["c"]["start"] in (1, 2)
    np.testing.assert_allclose(a[0]["c"]["losses"] + b[0]["c"]["losses"], whole["losses"], rtol=1e-5)
    for res in b:
        assert res["c"]["start"] == 2
        _assert_params_close(res["c"]["params"], whole["params"], 1e-5)
        assert res["c"]["result"] == whole["result"]


# -- the entry point -------------------------------------------------------------

def test_run_main_on_a_mesh_logs_from_the_primary_only(tmp_path):
    single = W.run_main(None, str(tmp_path / "single"))
    ranks = W.run_world(2, 1, [("run", W.run_main, (str(tmp_path / "mesh"),), {})], str(tmp_path / "w"))
    assert [r["run"]["result"] for r in ranks] == [single["result"]] * 2
    assert len(ranks[0]["run"]["logs"]) == len(ranks[0]["run"]["records"]) == 1


def test_mesh_model_axis_two_on_one_rank_raises(tmp_path):
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1 devices"):
        W.run_main(None, str(tmp_path), extra=["--mesh.model_axis=2"])


def test_make_mesh_checks_cover_then_needs_a_group():
    with pytest.raises(ValueError, match="mesh 3x1 does not cover 4 devices"):
        make_mesh(n_data=3, n_model=1, world=4)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_initialize_multihost_without_a_cluster_is_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_multihost() == (0, 1)
    assert distributed.is_primary_host()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_multihost(num_processes=2, process_id=0)
    distributed.barrier()  # nothing to wait for
    assert distributed.default_backend(local_world=1) in ("nccl", "gloo")


# -- the settings (the open fault: read and checked as the JAX package does) ----

@pytest.mark.parametrize("flag, want", [("auto", "auto"), ("on", "on"), ("OFF", "off"), (1, "on"), ("0", "off"),
                                        ("true", "on"), ("False", "off")])
def test_eval_item_shard_spellings(flag, want):
    trainer = W.make_trainer("MF", None, eval_item_shard=flag)
    assert trainer.evaluator.evaluator._item_shard_mode() == want


@pytest.mark.parametrize("flag", ["yes", "2", "sharded"])
def test_bad_eval_item_shard_raises(flag):
    with pytest.raises(ValueError, match="eval_item_shard must be"):
        W.make_trainer("MF", None, eval_item_shard=flag)


def test_item_shard_on_without_a_mesh_warns(caplog):
    trainer = W.make_trainer("MF", None, eval_item_shard="on")
    with caplog.at_level(logging.WARNING, logger="neurec_tpu_torch.eval"):
        trainer.initialize()
        trainer.evaluate()
    assert any("eval_item_shard=on ignored" in r.getMessage() for r in caplog.records)
    assert trainer.evaluator.evaluator._get_program(trainer.model.predict).plan.name == "bits"


def test_neurec_eval_item_shard_env_is_read(monkeypatch):
    trainer = W.make_trainer("MF", None, eval_item_shard="off")
    monkeypatch.setenv("NEUREC_EVAL_ITEM_SHARD", "1")
    assert trainer.evaluator.evaluator._item_shard_mode() == "on"
    monkeypatch.setenv("NEUREC_EVAL_ITEM_SHARD", "0")
    assert trainer.evaluator.evaluator._item_shard_mode() == "off"


# -- the mesh module's pieces ---------------------------------------------------

def test_outside_a_split_step_the_context_is_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert whole_term(x) is x and batch_sum(x) is x
    assert torch.equal(split_draw(lambda s: torch.ones(s), (3, 2)), torch.ones(3, 2))


def test_split_draw_keeps_this_ranks_rows_of_the_whole_draw():
    fake = types.SimpleNamespace(shape={"data": 3, "model": 1}, coordinate={"data": 1, "model": 0})
    draws = []
    with batch_split(types.SimpleNamespace(index=1, count=3, mesh=fake)):
        got = split_draw(lambda s: draws.append(s) or torch.arange(np.prod(s)).reshape(s), (2, 4))
        assert float(whole_term(torch.tensor(5.0))) == 0.0
    assert draws == [(6, 4)]
    assert torch.equal(got, torch.arange(24).reshape(6, 4)[2:4])


def test_placements_take_this_ranks_block():
    fake = types.SimpleNamespace(shape={"data": 2, "model": 3}, coordinate={"data": 1, "model": 2})
    x = torch.arange(20).reshape(10, 2)
    assert torch.equal(global_device_put(x, Placement("data", 0), fake), x[5:10])
    block = global_device_put(x, Placement("model", 0), fake)
    assert torch.equal(block, x[8:10])  # blocks of ceil(10 / 3)
    # a block owns its storage: a view would keep the whole table alive
    assert block.untyped_storage().nbytes() == 2 * 2 * x.element_size()
    w = torch.ones(10, 2, requires_grad=True)
    placed_w = shard_params({"w": w}, {"w": Placement("model", 0)}, fake)["w"]
    assert placed_w.is_leaf and placed_w.requires_grad
    assert placed_w.untyped_storage().nbytes() == 2 * 2 * w.element_size()
    assert torch.equal(global_device_put(x, Placement("model", 1), fake), x[:, 0:0])
    params = {"a": x, "b": [x]}
    placed = shard_params(params, {"a": Placement(), "b": [Placement()]}, fake)
    assert placed["a"] is x and placed["b"][0] is x
    assert shard_params(params, None) is params
