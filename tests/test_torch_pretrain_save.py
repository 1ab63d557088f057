"""``pretrain.save_pretrain`` in both directions, and the warm starts.

* The port writes each layout (MF, GMF, MLP, FISM, IRGAN) from its params,
  nested where the layout is dotted; the JAX package's ``try_load`` reads
  the same arrays (exact), and the port's ``try_load`` reads the pickles the
  JAX package writes (exact).
* NeuMF (an MF and an MLP pickle), NAIS and DeepICF (a FISM pickle) and
  ConvNCF (an MF ``[P, Q]`` pickle, or a P and a Q pickle) load the arrays
  into their params and log "load pretrained params successful!"; an
  unreadable file logs "unsuccessful!" and leaves the model's own init.
"""

import pickle

import numpy as np
import pytest
import torch

from neurec_tpu import pretrain as jax_pretrain
from neurec_tpu_torch import pretrain
from neurec_tpu_torch.bridge import params_from_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model

U, I = 30, 40


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "user_emb": rng.randn(U, 8).astype(np.float32), "item_emb": rng.randn(I, 8).astype(np.float32),
        "mlp_user": rng.randn(U, 4).astype(np.float32), "mlp_item": rng.randn(I, 4).astype(np.float32),
        "Q_set": rng.randn(I, 8).astype(np.float32), "Q": rng.randn(I, 8).astype(np.float32),
        "bias": rng.randn(I).astype(np.float32),
        "gen": {"user_emb": rng.randn(U, 8).astype(np.float32), "item_emb": rng.randn(I, 8).astype(np.float32),
                "item_bias": rng.randn(I).astype(np.float32)},
    }


@pytest.mark.parametrize("layout", sorted(pretrain._LAYOUTS))
def test_port_writes_what_the_jax_package_reads(layout, tmp_path):
    assert pretrain._LAYOUTS == jax_pretrain._LAYOUTS
    arrays = _arrays(1)
    path = str(tmp_path / "sub" / ("%s.pkl" % layout))
    pretrain.save_pretrain(layout, params_from_numpy(arrays, "cpu"), path)
    loaded = jax_pretrain.try_load(path)[0]
    want = [jax_pretrain._resolve(arrays, k) for k in jax_pretrain._LAYOUTS[layout]]
    assert len(loaded) == len(want)
    for got, ref in zip(loaded, want):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("layout", sorted(pretrain._LAYOUTS))
def test_port_reads_what_the_jax_package_writes(layout, tmp_path):
    arrays = _arrays(2)
    path = str(tmp_path / ("%s.pkl" % layout))
    jax_pretrain.save_pretrain(layout, arrays, path)
    loaded = pretrain.try_load(path)[0]
    for got, key in zip(loaded, pretrain._LAYOUTS[layout]):
        np.testing.assert_array_equal(got, pretrain._resolve(arrays, key))


def test_unknown_layout_raises(tmp_path):
    with pytest.raises(ValueError, match="no pretrain layout"):
        pretrain.save_pretrain("NGCF", {}, str(tmp_path / "x.pkl"))


@pytest.fixture
def said(monkeypatch):
    lines = []
    monkeypatch.setattr(pretrain.log, "info", lines.append)
    return lines


def _model(name, **conf):
    ds = random_dataset(num_users=U, num_items=I, seed=3)
    return get_model(name)(ds, DictConfig(conf), device="cpu")


def test_neumf_warm_starts_from_mf_and_mlp(tmp_path, said):
    arrays = _arrays(3)
    mf, mlp = str(tmp_path / "mf.pkl"), str(tmp_path / "mlp.pkl")
    pretrain.save_pretrain("MF", params_from_numpy(arrays, "cpu"), mf)
    pretrain.save_pretrain("MLP", params_from_numpy(arrays, "cpu"), mlp)
    model = _model("NeuMF", embedding_size=8, layers=[8, 4], mf_pretrain=mf, mlp_pretrain=mlp)
    params = model.init_params(torch.Generator().manual_seed(0))
    for key, src in (("mf_user", "user_emb"), ("mf_item", "item_emb"), ("mlp_user", "mlp_user"),
                     ("mlp_item", "mlp_item")):
        np.testing.assert_array_equal(params[key].numpy(), arrays[src])
    assert said[-1].startswith("load pretrained params successful!")
    assert [tuple(layer["w"].shape) for layer in params["tower"]] == [(8, 8), (8, 4)]


@pytest.mark.parametrize("name", ["NAIS", "DeepICF"])
def test_item_similarity_models_warm_start_from_fism(name, tmp_path, said):
    arrays = _arrays(4)
    path = str(tmp_path / "fism.pkl")
    pretrain.save_pretrain("FISM", params_from_numpy(arrays, "cpu"), path)
    model = _model(name, embedding_size=8, weight_size=4, layers=[8, 4], pretrain_file=path)
    params = model.init_params(torch.Generator().manual_seed(0))
    for key in ("Q_set", "Q", "bias"):
        np.testing.assert_array_equal(params[key].numpy(), arrays[key])
    assert said[-1].startswith("load pretrained params successful!")
    with open(path, "wb") as fout:
        fout.write(pickle.dumps([1])[:3])  # truncated
    params = _model(name, embedding_size=8, weight_size=4, pretrain_file=path).init_params(
        torch.Generator().manual_seed(0))
    assert params["Q"].shape == (I, 8) and said[-1].startswith("load pretrained params unsuccessful!")


def test_convncf_warm_starts_from_an_mf_pair_or_two_files(tmp_path, said):
    arrays = _arrays(5)
    path = str(tmp_path / "mf.pkl")
    pretrain.save_pretrain("MF", params_from_numpy(arrays, "cpu"), path)
    conf = dict(embedding_size=8, net_channel=[2, 2, 2])
    params = _model("ConvNCF", mf_pretrain=path, **conf).init_params(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(params["embedding_P"].numpy(), arrays["user_emb"])
    np.testing.assert_array_equal(params["embedding_Q"].numpy(), arrays["item_emb"])
    assert said[-1].startswith("load pretrained params successful!")
    p_path, q_path = str(tmp_path / "p.pkl"), str(tmp_path / "q.pkl")
    for file, arr in ((p_path, arrays["user_emb"]), (q_path, arrays["item_emb"])):
        with open(file, "wb") as fout:
            pickle.dump(arr, fout)
    params = _model("ConvNCF", mf_pretrain=p_path, mlp_pretrain=q_path, **conf).init_params(
        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(params["embedding_P"].numpy(), arrays["user_emb"])
    np.testing.assert_array_equal(params["embedding_Q"].numpy(), arrays["item_emb"])
    assert [tuple(c["w"].shape) for c in params["conv"]] == [(2, 2, 1, 2), (2, 2, 2, 2), (2, 2, 2, 2)]
