"""The general models' epochs and optimizers against the JAX package's, on
the CPU, and their runs through ``Trainer`` and ``run.main``.

* One epoch with the JAX epoch's own draws (``_jax_epoch_draws`` of
  test_torch_training.py: permutation, weights, negatives per step) fed to
  the port's ``run_epoch``, epoch number 3 in both (APR's ``adv_epoch``
  switch): the epoch loss to rtol 1e-5 and the params after the epoch to
  atol 2e-5 (Adam / Adagrad steps magnify the gradients' f32 noise; see
  test_torch_training.py). Under batch norm DeepICF's ``deep_b`` has an
  exactly zero gradient (the batch mean removes it), so Adam turns f32
  noise of ~1e-9 into steps of lr in either package: those leaves are
  held to the loss instead, which they do not move.
* ConvNCF's two Adagrads (``make_optimizer``: ``lr_embed`` for the
  embedding tables, ``lr_net`` for the rest, accumulators from 0.1) against
  ``optax.multi_transform`` over a few steps of the same gradients: params
  and accumulators to rtol 1e-6.
* Every model trains and evaluates through ``run.main`` on a tiny rating
  file on the CPU, each at its ``conf/<Model>.properties``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import map_params, param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig
from neurec_tpu_torch.trainer import OptaxAdagrad, Trainer
from tests.test_torch_general_zoo import CONFS, build_both, numpy_params
from tests.test_torch_training import SilentLogger, _jax_epoch_draws

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_CASES = ["mlp-bpr", "mlp-ce", "neumf-ce", "neumf-bpr", "apr-grad", "fism-square", "fism-bpr",
               "nais-prod", "nais-concat", "deepicf-bn", "dmf-ce", "convncf"]


@pytest.mark.parametrize("name", EPOCH_CASES)
def test_epoch_with_injected_jax_draws_matches_jax(name):
    conf = CONFS[name]
    ds_j, ds, model_j, model = build_both(conf, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    assert trainer.steps == -(-(trainer.n_instances) // model.batch_size)

    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, inst, w, negs = _jax_epoch_draws(jt, epoch=3)
    assert (w == 0).any()
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(3))

    params = map_params(lambda t: t.requires_grad_(True), params_from_numpy(params_np, "cpu"))
    params, _, loss = trainer.run_epoch(params, trainer.init_opt_state(params), torch.from_numpy(inst),
                                        torch.from_numpy(w), torch.from_numpy(negs), epoch=3)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    start = dict(param_leaves(params_np))
    moved = False
    for path, p in param_leaves(params_to_numpy(params)):
        if conf.get("batch_norm") and path[0] == "deep_b":
            continue
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))
        moved |= not np.allclose(p, start[path])
    assert moved


def test_convncf_two_adagrads_match_optax_multi_transform():
    conf = CONFS["convncf"]
    _, ds, model_j, model = build_both(conf)
    params_np = numpy_params(model_j, 6)
    tx = model_j.make_optimizer()
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    state_j = tx.init(params_j)
    params = map_params(lambda t: t.requires_grad_(True), params_from_numpy(params_np, "cpu"))
    opt = model.make_optimizer()(params)
    assert isinstance(opt, OptaxAdagrad)
    assert [g["lr"] for g in opt.param_groups] == [conf["lr_embed"], conf["lr_net"]]
    rng = np.random.RandomState(7)
    for _ in range(4):
        grads_np = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), params_np)
        updates, state_j = tx.update(jax.tree_util.tree_map(jnp.asarray, grads_np), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        grads = dict(param_leaves(grads_np))
        for path, p in param_leaves(params):
            p.grad = torch.from_numpy(grads[path])
        opt.step()
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    for path, p in param_leaves(params):
        np.testing.assert_allclose(p.detach().numpy(), want[path], rtol=1e-6, atol=1e-7, err_msg=str(path))
    # the accumulators, label by label (optax's inner states are keyed by label)
    inner = state_j.inner_states
    acc_j = {label: dict(param_leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x) if x is not None else None, inner[label].inner_state[0].sum_of_squares)))
        for label in ("embed", "net")}
    for path, p in param_leaves(params):
        label = "embed" if path[0] in ("embedding_P", "embedding_Q") else "net"
        np.testing.assert_allclose(opt.state[p]["sum_of_squares"].numpy(), acc_j[label][path], rtol=1e-6,
                                   err_msg=str(path))


def test_trainer_takes_the_model_optimizer_and_epoch():
    conf = dict(CONFS["convncf"], epochs=1)
    _, ds, _, model = build_both(conf)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    trainer.initialize()
    groups = trainer.opt_state.param_groups
    assert [len(g["params"]) for g in groups] == [2, 2 * len(model.nc) + 2]
    assert groups[0]["params"][0] is trainer.params["embedding_P"]
    seen = []
    real_loss = model.loss

    def spy(params, batch, weights):
        seen.append(batch["epoch"])
        return real_loss(params, batch, weights)

    model.loss = spy
    draws = trainer.draw_epoch(trainer.epoch_generator(1))
    trainer.run_epoch(trainer.params, trainer.opt_state, *draws, epoch=4)
    assert seen == [4] * trainer.steps
    # a model's init_opt_state comes before its make_optimizer
    mine = torch.optim.SGD([trainer.params["W"]], lr=0.1)
    model.init_opt_state = lambda params: mine
    assert trainer.init_opt_state(trainer.params) is mine


def _write_ratings(path, seed=0, n_users=48, n_items=70):
    rng = np.random.RandomState(seed)
    lines = ["%d,%d,%d" % (u, i, rng.randint(1, 6)) for u in range(n_users)
             for i in rng.choice(n_items, rng.randint(4, 14), replace=False)]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("name,extra", [
    ("MLP", ["--layers=[8,4,2]"]),
    ("NeuMF", ["--layers=[8,4,2]", "--embedding_size=4"]),
    ("APR", ["--embedding_size=8"]),
    ("FISM", ["--embedding_size=8"]),
    ("NAIS", ["--embedding_size=8", "--weight_size=4"]),
    ("DeepICF", ["--embedding_size=8", "--weight_size=4", "--layers=[8,4]"]),
    ("DMF", ["--layers=[16,8]"]),
    ("ConvNCF", ["--embedding_size=8", "--net_channel=[4,4,4]"]),
])
def test_run_main_trains_and_evaluates_each_model(name, extra, tmp_path, monkeypatch):
    from neurec_tpu_torch import run

    monkeypatch.chdir(tmp_path)  # the run logger writes under ./log
    (tmp_path / "data").mkdir()
    _write_ratings(tmp_path / "data" / "syn.rating")
    args = ["--recommender=%s" % name, "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--data.input.path=%s" % (tmp_path / "data"), "--data.cache.path=%s" % (tmp_path / "cache"),
            "--data.input.dataset=syn", "--data.column.format=UIR", "--data.convert.separator=','",
            "--epochs=2", "--batch_size=64", "--topk=[5]", "--metric=[\"Recall\",\"NDCG\"]",
            "--pretrain_file=", "--mf_pretrain=", "--mlp_pretrain="] + extra
    trainer, result = run.main(os.path.join(REPO, "NeuRec.properties"), args, device="cpu")
    values = [float(x) for x in result.split("\t")]
    assert len(values) == 2 and all(0.0 <= v <= 1.0 for v in values)
    records = list((tmp_path / "log" / "syn" / name).glob("*.log.metrics.jsonl"))
    assert len(records) == 1
    losses = [float(line.split('"loss": ')[1].split(",")[0]) for line in records[0].read_text().splitlines()]
    assert len(losses) == 2 and np.isfinite(losses).all()
