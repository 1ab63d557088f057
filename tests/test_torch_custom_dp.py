"""The custom epochs split over 'data': SBPR, Caser, SRGNN, JCA, CFGAN (both
sub-steps) and IRGAN's D pass, on gloo worlds of CPU processes
(``tests/torch_mesh_worker.py``), each held to the port's own single-device
run on the same draws, as ``tests/test_torch_mesh.py`` holds the built-in
epochs:

* on (2, 1) and (4, 1) meshes, two epochs: every rank's epoch losses within
  rtol 1e-5, its params within 1e-5 and its metric string equal;
* the loss methods of each step (``torch_mesh_worker.CUSTOM_LOSSES``)
  receive B / n rows on each rank of (2, 1), (4, 1) and (2, 2), the whole
  batch without a mesh;
* on a (1, 1) mesh (one 'data' rank) the losses and params are the single
  run's bits;
* DeepICF with batch norm runs its step whole on every rank (its loss fed
  the whole batch on (2, 1), (4, 1) and (2, 2)), with the single run's
  losses, params and string: its first layer's statistics are too
  ill-conditioned in f32 for a split to stay within 1e-5 on the card.
"""

import numpy as np
import pytest
import torch

from tests import torch_mesh_worker as W

SHAPES = [(2, 1), (4, 1)]
SPY_SHAPES = [(2, 1), (4, 1), (2, 2)]
MODELS = W.CUSTOM_DP + ["DeepICF"]

torch.set_float32_matmul_precision("highest")


def _root(tmp_path_factory, name):
    return str(tmp_path_factory.mktemp("social_" + name.lower()))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    root = _root(tmp_path_factory, "single")
    out = {"train:" + n: W.train(None, n, root=root) for n in MODELS}
    out.update({"shapes:" + n: W.batch_shapes(None, n, root=root) for n in MODELS})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for shape in SHAPES + [(2, 2), (1, 1)]:
        root = _root(tmp_path_factory, "%dx%d" % shape)
        cases = []
        if shape in SHAPES or shape == (1, 1):
            cases += [("train:" + n, W.train, (n,), dict(root=root)) for n in MODELS]
        if shape in SPY_SHAPES:
            cases += [("shapes:" + n, W.batch_shapes, (n,), dict(root=root)) for n in MODELS]
        out[shape] = W.run_world(shape[0] * shape[1], shape[1], cases,
                                 str(tmp_path_factory.mktemp("world%dx%d" % shape)))
    return out


def _assert_matches(got, want, rank):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, err_msg="rank %d" % rank)
    a, b = W.leaves(got["params"]), W.leaves(want["params"])
    assert set(a) == set(b)
    for path in a:
        np.testing.assert_allclose(a[path], b[path], rtol=0, atol=1e-5, err_msg="rank %d %s" % (rank, path))
    assert got["result"] == want["result"], "rank %d" % rank
    assert got["warnings"] == []


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", W.CUSTOM_DP)
def test_custom_epoch_split_matches_single(worlds, single, shape, name):
    for rank, res in enumerate(worlds[shape]):
        _assert_matches(res["train:" + name], single["train:" + name], rank)


@pytest.mark.parametrize("shape", SPY_SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", W.CUSTOM_DP)
def test_custom_loss_sees_this_ranks_rows(worlds, single, shape, name):
    whole = single["shapes:" + name]
    assert set(whole) == set(W.CUSTOM_LOSSES[name])
    for res in worlds[shape]:
        got = res["shapes:" + name]
        assert got == {k: v // shape[0] for k, v in whole.items()}, got


@pytest.mark.parametrize("name", MODELS)
def test_one_data_rank_gives_the_single_bits(worlds, single, name):
    want = single["train:" + name]
    (got,) = (res["train:" + name] for res in worlds[(1, 1)])
    assert got["losses"] == want["losses"]
    a, b = W.leaves(got["params"]), W.leaves(want["params"])
    assert set(a) == set(b)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=str(path))
    assert got["result"] == want["result"]


@pytest.mark.parametrize("shape", SPY_SHAPES, ids=lambda s: "%dx%d" % s)
def test_deepicf_batch_norm_step_runs_whole(worlds, single, shape):
    whole = single["shapes:DeepICF"]
    assert set(whole.values()) == {W.BATCH}
    for rank, res in enumerate(worlds[shape]):
        assert res["shapes:DeepICF"] == whole
        if shape in SHAPES:
            _assert_matches(res["train:DeepICF"], single["train:DeepICF"], rank)
