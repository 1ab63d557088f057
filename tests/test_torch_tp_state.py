"""The state of a run whose tables are row-sharded over 'model', across
mesh shapes, on gloo worlds of CPU processes (``tests/torch_mesh_worker.py``).

* Checkpoints hold whole tensors: a run saved on (1, 2) resumes on (1, 1),
  and one saved on (1, 1) resumes on (2, 2), each equal to the
  uninterrupted run (losses within rtol 1e-5, params within 1e-5, the
  metric string equal), with Adam's moments re-blocked to the resuming
  mesh's blocks.
* ``params_to_numpy`` and ``save_pretrain``, called by every rank of a
  (1, 2) world, give the whole tables.
* Each rank of a (1, 2) world holds half of MF's tables and half of their
  Adam moments (the bytes of the tensors' storage).
* ``run.main`` on a (1, 2) mesh trains with sharded tables, gives the
  single run's string and logs from the primary rank only.
"""

import os

import numpy as np
import pytest
import torch

from tests import torch_mesh_worker as W

torch.set_float32_matmul_precision("highest")

TABLES = [("item_emb",), ("user_emb",)]


def _assert_params_close(got, want, atol=1e-5):
    got, want = W.leaves(got), W.leaves(want)
    assert set(got) == set(want)
    for path in got:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol, err_msg=str(path))


@pytest.fixture(scope="module")
def model_axis_world(tmp_path_factory):
    """One (1, 2) world: a checkpoint written at epoch 1, the resident
    bytes, the pretrain pickle and ``run.main``."""
    root = tmp_path_factory.mktemp("tp12")
    cases = [("ckpt", W.checkpoint_case, (str(root / "ckpt"), 1), {}),
             ("bytes", W.resident_bytes, (), {}),
             ("pretrain", W.pretrain_case, (str(root / "mf.pkl"),), {}),
             ("run", W.run_main, (str(root / "run"),), {})]
    return root, W.run_world(2, 2, cases, str(root / "world"))


@pytest.mark.parametrize("first, second", [((1, 2), (1, 1)), ((1, 1), (2, 2))], ids=["1x2_to_1x1", "1x1_to_2x2"])
def test_checkpoint_resumes_on_another_mesh_shape(model_axis_world, tmp_path, first, second):
    whole = W.checkpoint_case(None, str(tmp_path / "whole"), 2)
    if first == (1, 2):
        root, ranks = model_axis_world
        ckpt, a = str(root / "ckpt"), [r["ckpt"] for r in ranks]
    else:
        ckpt = str(tmp_path / "ckpt")
        a = [r["c"] for r in W.run_world(1, 1, [("c", W.checkpoint_case, (ckpt, 1), {})], str(tmp_path / "a"))]
    # the file holds whole tensors, Adam's moments too
    state = torch.load(os.path.join(ckpt, "ckpt-1.pt"), map_location="cpu", weights_only=True)
    assert {k: tuple(v.shape) for k, v in state["params"].items()} == {"user_emb": (40, 8), "item_emb": (48, 8)}
    moments = state["opt_state"]["__optimizer_state_dict__"]["state"]
    assert sorted(tuple(s["exp_avg"].shape) for s in moments.values()) == [(40, 8), (48, 8)]
    world = second[0] * second[1]
    b = W.run_world(world, second[1], [("c", W.checkpoint_case, (ckpt, 2), {})], str(tmp_path / "b"))
    np.testing.assert_allclose(a[0]["losses"] + b[0]["c"]["losses"], whole["losses"], rtol=1e-5)
    for res in b:
        got = res["c"]
        assert got["start"] == 2
        # the moments restored as this mesh's blocks (each of exp_avg, exp_avg_sq)
        assert got["moment_rows"] == {("user_emb",): [40 // second[1]] * 2, ("item_emb",): [48 // second[1]] * 2}
        _assert_params_close(got["params"], whole["params"])
        assert got["result"] == whole["result"]


def test_params_to_numpy_and_save_pretrain_give_whole_tables(model_axis_world, tmp_path):
    want = W.pretrain_case(None, str(tmp_path / "mf.pkl"))
    assert [w.shape for w in want["written"]] == [(40, 8), (48, 8)]
    for res in model_axis_world[1]:
        got = res["pretrain"]
        for g, w in zip(got["written"], want["written"]):
            np.testing.assert_array_equal(g, w)
        for path, v in W.leaves(want["params"]).items():
            np.testing.assert_array_equal(W.leaves(got["params"])[path], v)


def test_each_rank_holds_half_of_the_tables_and_their_adam_moments(model_axis_world):
    whole = W.resident_bytes(None)
    assert whole["shards"] == [] and whole["params"] == (40 + 48) * 8 * 4
    for res in model_axis_world[1]:
        got = res["bytes"]
        assert got["shards"] == TABLES
        assert got["params"] * 2 == whole["params"]
        assert got["adam"] * 2 == whole["adam"] == 2 * whole["params"]


def test_run_main_on_a_model_axis_trains_sharded_tables(model_axis_world, tmp_path):
    single = W.run_main(None, str(tmp_path / "single"))
    assert single["shards"] == []
    ranks = model_axis_world[1]
    assert [r["run"]["result"] for r in ranks] == [single["result"]] * 2
    assert all(r["run"]["shards"] == TABLES for r in ranks)
    assert len(ranks[0]["run"]["logs"]) == len(ranks[0]["run"]["records"]) == 1
