"""The id tables row-sharded over 'model', zoo-wide: the port's counterpart
of ``tests/test_zoo_sharding.py``.

* Placement parity with the JAX package, no world: for each of the 35
  models on the 60-user by 80-item synthetic set (the JAX test's
  properties), the leaf paths that the JAX ``param_shardings`` row-shards
  on its (4, 2) virtual-CPU mesh are the paths that the port's
  ``param_shardings`` row-shards for a 'model' axis of 2 (the names are the
  same in both packages, ``bridge.py``); Pop has none. With 61 users the
  user tables do not divide the axis and stay replicated in both.
* One gloo world of 4 CPU ranks on a (2, 2) mesh, spawned once, runs every
  model (``torch_mesh_worker.zoo_case``): each sharded leaf is the rank's
  N/2-row block at its offset, a tensor whose storage holds that block
  only; one epoch cut to 3 steps matches the model's single-device run
  (losses within rtol 1e-5, the gathered params within 1e-5, GRU4Rec
  1e-4 and SASRec's attention key biases exempt, as
  ``tests/test_torch_mesh.py`` states them), the metric string equal
  character for character, and the ranks of one 'model' coordinate (which
  ``Trainer.dp_sync_grads`` pairs over 'data') hold equal blocks.
"""

import jax
import numpy as np
import pytest
import torch

from neurec_tpu.data.dataset import Dataset as JaxDataset
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.models import registered_models as jax_registered_models
from neurec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from neurec_tpu_torch.bridge import param_leaves
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.models import PORT_ONLY, get_model, registered_models
from tests import torch_mesh_worker as W
from tests.helpers import make_config, make_synthetic_dataset
from tests.test_zoo_sharding import NO_TABLE, _props_for
from tests.test_social_models import _make_social_file

torch.set_float32_matmul_precision("highest")

PARAM_ATOL = {"GRU4Rec": 1e-4}


class _ModelAxis:
    """A mesh as ``param_shardings`` reads it: the axis sizes only."""

    def __init__(self, n_model):
        self.shape = {"data": 4, "model": n_model}
        self.coordinate = {"data": 0, "model": 0}


def _jax_sharded(model):
    shardings = model.param_shardings(jax_make_mesh(n_data=4, n_model=2))
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, s in flat if len(s.spec) and s.spec[0] == "model"}


def _port_sharded(model):
    params = model.init_params(torch.Generator().manual_seed(0))
    placements = model.param_shardings(_ModelAxis(2), params)
    out = set()
    for path, _ in param_leaves(params):
        p = placements
        for part in path:
            p = p[part]
        if p.axis == "model":
            out.add(path)
    return out


def _both(tmp_path, name, num_users=60):
    """The JAX model and the port's on the same files."""
    make_synthetic_dataset(tmp_path, num_users=num_users, num_items=80)
    social = str(_make_social_file(tmp_path, num_users=num_users))
    conf_j = make_config(tmp_path, recommender=name, alg_props=_props_for(name, social))
    model_j = jax_get_model(name)(JaxDataset(conf_j), conf_j)
    conf = Config(str(tmp_path / "NeuRec.properties"), cmd_args=["--data.cache.path=%s" % (tmp_path / "port")])
    return model_j, get_model(name)(Dataset(conf), conf, device="cpu")


def test_the_parity_covers_both_registries():
    """The port holds the JAX zoo's 35 and, beyond them, exactly its own
    models (``PORT_ONLY``), which no JAX model mirrors."""
    assert sorted(jax_registered_models()) == W.ALL_MODELS
    assert len(W.ALL_MODELS) == 35
    assert PORT_ONLY == ("HSTU",) and not set(PORT_ONLY) & set(W.ALL_MODELS)
    assert sorted(registered_models()) == sorted(W.ALL_MODELS + list(PORT_ONLY))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("name", sorted(jax_registered_models()))
def test_port_shards_the_leaves_the_jax_package_shards(tmp_path, name):
    model_j, model = _both(tmp_path, name)
    want, got = _jax_sharded(model_j), _port_sharded(model)
    assert got == want
    assert bool(got) == (name not in NO_TABLE)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_a_table_that_does_not_divide_the_axis_stays_replicated(tmp_path):
    model_j, model = _both(tmp_path, "MF", num_users=61)
    assert model.num_users == 61
    assert _jax_sharded(model_j) == _port_sharded(model) == {("item_emb",)}


# -- the (2, 2) world ------------------------------------------------------------

@pytest.fixture(scope="module")
def zoo_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo22")
    cases = [("zoo:" + n, W.zoo_case, (n, str(root / n)), {}) for n in W.ALL_MODELS]
    return W.run_world(4, 2, cases, str(root / "world"), timeout_s=600)


@pytest.fixture(scope="module")
def zoo_single(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo11")
    return {n: W.zoo_case(None, n, str(root / n)) for n in W.ALL_MODELS}


@pytest.mark.parametrize("name", W.ALL_MODELS)
def test_sharded_zoo_matches_single_device(zoo_world, zoo_single, name):
    want = zoo_single[name]
    exempt = (("att", "k", "b"),) if name == "SASRec" else ()
    paths = set(W.leaves(want["init"]))
    sharded = set(zoo_world[0]["zoo:" + name]["placed"])
    if name != "Pop":
        assert sharded, "%s: no table was row-sharded" % name
    for rank, res in enumerate(zoo_world):
        got = res["zoo:" + name]
        m = rank % 2  # rank d * 2 + m sits at (d, m)
        assert set(got["placed"]) == sharded and sharded <= paths
        init = W.leaves(got["init"])
        for path, placed in got["placed"].items():
            n = placed["rows"] // 2
            assert placed["rows"] % 2 == 0 and placed["lo"] == m * n
            block = got["before"][path]
            assert block.shape == (n,) + init[path].shape[1:]
            assert placed["storage"] == placed["nbytes"] == block.nbytes, (rank, path)
            np.testing.assert_array_equal(block, init[path][m * n: (m + 1) * n])
            np.testing.assert_array_equal(got["after"][path], W.leaves(got["params"])[path][m * n: (m + 1) * n])
            # the 'data' sum pairs ranks of one 'model' coordinate: equal blocks
            np.testing.assert_array_equal(got["after"][path], zoo_world[m]["zoo:" + name]["after"][path])
        for path, v in W.leaves(want["init"]).items():
            np.testing.assert_array_equal(init[path], v, err_msg=str(path))
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, err_msg="rank %d" % rank)
        a, b = W.leaves(got["params"]), W.leaves(want["params"])
        assert set(a) == set(b)
        for path in a:
            if not any(path[-len(e):] == e for e in exempt):
                np.testing.assert_allclose(a[path], b[path], rtol=0, atol=PARAM_ATOL.get(name, 1e-5),
                                           err_msg="rank %d %s" % (rank, path))
        assert got["result"] == want["result"], "rank %d" % rank
