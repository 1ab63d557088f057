"""The ``dense_row`` epoch (MultiDAE, MultiVAE, DAE, CDAE) against the JAX
package's, on the CPU.

* One epoch on the JAX epoch's own draws: its permutation of the users and
  weights (neurec_tpu/trainer.py:461-473), fed to the port's ``run_epoch``,
  and the draws each JAX step's loss makes from its key (dropout,
  corruption, the VAE's noise, CDAE's negatives), handed to the port's
  draw methods step by step. Epoch 3 in both, so that MultiVAE's KL anneal
  reads global steps past the first epoch's. The epoch loss to rtol 1e-5,
  the params after it to atol 2e-5 (Adam magnifies the gradients' f32
  noise; see test_torch_training.py).
* The trainer's side of the epoch: the instances are the sorted users with
  train items, ``negs`` is empty, each batch carries dense rows equal to
  the JAX package's and the global step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import map_params, param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_general_rest import CONFS, build_both, inject, jax_loss_draws, numpy_params
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

DENSE_ROW = ["multidae", "multivae", "dae", "dae-softmax", "cdae", "cdae-square"]


def jax_dense_row_draws(jt, epoch):
    """The JAX dense_row epoch's permutation, weights and step keys, rebuilt
    outside its jitted scan."""
    B, N = jt.model.batch_size, len(jt._users_flat)
    steps = -(-N // B)
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    idx = jnp.where(perm < N, perm, 0).astype(jnp.int32).reshape(steps, B)
    w = (perm < N).astype(jnp.float32).reshape(steps, B)
    return ekey, np.array(idx), np.array(w), jax.random.split(kn, steps)


@pytest.mark.parametrize("name", DENSE_ROW)
def test_epoch_with_injected_jax_draws_matches_jax(name):
    conf = dict(CONFS[name], batch_size=12)
    ds_j, ds, model_j, model = build_both(conf, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    np.testing.assert_array_equal(trainer._users_flat.numpy(), jt._users_flat)
    assert trainer.steps == -(-len(jt._users_flat) // model.batch_size)

    params_np = numpy_params(model_j, 5, scale=0.3)
    epoch = 3
    ekey, idx, w, step_keys = jax_dense_row_draws(jt, epoch)
    assert (w == 0).any()
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(epoch))

    draws = {}
    for s in range(trainer.steps):
        users = trainer._users_flat[torch.from_numpy(idx[s]).long()]
        step_draws = jax_loss_draws(model_j, step_keys[s], users.numpy(), np.zeros((len(users), model.num_items)))
        for k, v in step_draws.items():
            draws.setdefault(k, []).extend(v)
    inject(model, **draws)
    params = map_params(lambda t: t.requires_grad_(True), params_from_numpy(params_np, "cpu"))
    negs = torch.zeros((trainer.steps, 0), dtype=torch.int32)
    params, _, loss = trainer.run_epoch(params, trainer.init_opt_state(params), torch.from_numpy(idx),
                                        torch.from_numpy(w), negs, torch.arange(trainer.steps), epoch=epoch)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    start = dict(param_leaves(params_np))
    moved = False
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))
        moved |= not np.allclose(p, start[path])
    assert moved


def test_dense_row_batches_carry_rows_and_the_global_step():
    conf = dict(CONFS["multivae"], batch_size=16)
    ds_j, ds, model_j, model = build_both(conf)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    assert trainer.n_instances == len(ds.get_user_train_dict()) and trainer.steps == 3
    draws = trainer.draw_epoch(trainer.epoch_generator(1))
    assert draws.negs.shape == (3, 0) and draws.seeds.shape == (3,)
    assert sorted(draws.inst.reshape(-1)[draws.w.reshape(-1) > 0].tolist()) == list(range(trainer.n_instances))
    seen = []
    real_loss = model.loss

    def spy(params, batch, weights):
        seen.append((batch["step"], batch["epoch"]))
        want_rows = np.asarray(model_j.make_rows(jnp.asarray(batch["users"].numpy())))
        np.testing.assert_array_equal(batch["rows"].numpy(), want_rows)
        assert isinstance(batch["generator"], torch.Generator)
        return real_loss(params, batch, weights)

    model.loss = spy
    trainer.initialize()
    trainer.run_epoch(trainer.params, trainer.opt_state, *draws, epoch=2)
    assert seen == [(3, 2), (4, 2), (5, 2)]


def test_make_rows_matches_jax():
    _, _, model_j, model = build_both(CONFS["cdae"])
    users = np.array([0, 5, 5, 39], dtype=np.int32)
    np.testing.assert_array_equal(model.make_rows(torch.from_numpy(users).long()).numpy(),
                                  np.asarray(model_j.make_rows(jnp.asarray(users))))
