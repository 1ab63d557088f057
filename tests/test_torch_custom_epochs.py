"""The ``custom`` epochs (WRMF, JCA, CFGAN, IRGAN) and the ``none`` epoch
against the JAX package's, on the CPU, and the trainer around them.

* WRMF: one ALS epoch from the same factors within 1e-4 of the JAX one
  (ALS draws nothing; both solve in f32 by LU, in another order).
* JCA, CFGAN, IRGAN: one epoch on the JAX epoch's own draws, rebuilt from
  its key schedule (neurec_tpu/models/general/jca.py:141-164,
  cfgan.py:168-190, irgan.py:96-241) and handed to the port's draw methods:
  the permutations, JCA's negative columns, CFGAN's masks, IRGAN's
  negatives and samples (a G sample is drawn by ``jax.random.categorical``
  from the port's own logits, which track the JAX ones to f32 noise). The
  epoch loss to rtol 1e-5 and the params after it to atol 2e-5.
* IRGAN warm-starts from a pickle written by the port's ``save_pretrain``.
* ``Trainer``: the ``none`` epoch and ``epochs == 0`` evaluate only, a
  custom epoch comes from ``build_epoch``, the exclusion-table budget binds
  the sampled epochs only, and ``run.main`` trains and evaluates each of
  the 11 models at its ``conf/<Model>.properties``.
* K1's path choice, ``k1_path``: f32 FMAs up to d = 40, the 3xTF32 split
  above, the same bound as the CUDA source's.
"""

import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch import pretrain
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig
from neurec_tpu_torch.models.general.jca import GridDraws
from neurec_tpu_torch.ops import masked_scores as k1
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_general_epochs import _write_ratings
from tests.test_torch_general_rest import CONFS, build_both, inject, numpy_params
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def both_trainers(name, seed=4, **over):
    conf = dict(CONFS[name], **over)
    ds_j, ds, model_j, model = build_both(conf, seed=seed)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    trainer.initialize()
    return jt, trainer


def jax_epoch(jt, params_np, epoch):
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.model.init_opt_state(params_j)
                                       if hasattr(jt.model, "init_opt_state") else jt.tx.init(params_j),
                                       ekey, jnp.int32(epoch))
    return ekey, jax.tree_util.tree_map(np.asarray, params_j), float(loss_j)


def assert_params_close(params, want, start, atol=2e-5):
    want, start = dict(param_leaves(want)), dict(param_leaves(start))
    moved = False
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=atol, err_msg=str(path))
        moved |= not np.allclose(p, start[path])
    assert moved


def test_wrmf_one_als_epoch_matches_jax():
    jt, trainer = both_trainers("wrmf")
    params_np = numpy_params(jt.model, 5, scale=0.3)
    _, want, loss_j = jax_epoch(jt, params_np, 1)
    params, opt, loss = trainer._epoch_fn(params_from_numpy(params_np, "cpu"), trainer.opt_state,
                                          trainer.epoch_generator(1), 1)
    assert opt is None
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4)
    assert_params_close(params, want, params_np, atol=1e-4)


def test_wrmf_als_loss_falls():
    _, trainer = both_trainers("wrmf")
    losses = []
    for epoch in (1, 2, 3):
        trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch)
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0]


def test_jca_epoch_with_injected_jax_draws_matches_jax():
    jt, trainer = both_trainers("jca")
    model, B = trainer.model, trainer.model.batch_size
    params_np = numpy_params(jt.model, 5, scale=0.3)
    ekey, want, loss_j = jax_epoch(jt, params_np, 2)
    nU, nI = -(-model.num_users // B), -(-model.num_items // B)
    kr, kc, kn = jax.random.split(ekey, 3)
    rperm, cperm = jax.random.permutation(kr, nU * B), jax.random.permutation(kc, nI * B)
    draws = GridDraws(T(jnp.where(rperm < model.num_users, rperm, 0).reshape(nU, B)).long(),
                      T((rperm < model.num_users).astype(jnp.float32).reshape(nU, B)),
                      T(jnp.where(cperm < model.num_items, cperm, 0).reshape(nI, B)).long(),
                      T((cperm < model.num_items).astype(jnp.float32).reshape(nI, B)),
                      torch.arange(nU * nI))
    assert (draws.row_w == 0).any() and (draws.col_w == 0).any()
    inject(model, neg_cols=[T(jax.random.randint(k, (B, B, model.neg_sample_rate), 0, B)).long()
                            for k in jax.random.split(kn, nU * nI)])
    params = trainer.params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    params, _, loss = model.run_epoch(params, trainer.init_opt_state(params), draws)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert_params_close(params, want, params_np)


def jax_cfgan_draws(model_j, ekey):
    """CFGAN's permutations and masks in the port's call order."""
    kd, kg = jax.random.split(ekey)
    perms, masks = [], []
    n = model_j._n_rows
    for key, B, reps, d_phase in ((kd, model_j.batchSize_D, model_j.step_D, True),
                                  (kg, model_j.batchSize_G, model_j.step_G, False)):
        steps = max(n // B, 1)
        shape = (B, model_j._n_cols)
        for r in range(reps):
            kp, ks, key = jax.random.split(jax.random.fold_in(key, r), 3)
            perms.append(T(jax.random.permutation(kp, n)[: steps * B].reshape(steps, B)).long())
            for k in jax.random.split(ks, steps):
                if d_phase:
                    masks.append(T(jax.random.bernoulli(k, model_j.ZP_ratio, shape)))
                else:
                    k_zr, k_pm = jax.random.split(k)
                    masks += [T(jax.random.bernoulli(k_zr, model_j.ZR_ratio, shape)),
                              T(jax.random.bernoulli(k_pm, model_j.ZP_ratio, shape))]
    return perms, masks


@pytest.mark.parametrize("name", ["cfgan", "cfgan-item"])
def test_cfgan_epoch_with_injected_jax_draws_matches_jax(name):
    jt, trainer = both_trainers(name)
    model = trainer.model
    assert model.epochs == jt.model.epochs == 4 // model.step_G
    params_np = numpy_params(jt.model, 5, scale=0.3)
    ekey, want, loss_j = jax_epoch(jt, params_np, 1)
    perms, masks = jax_cfgan_draws(jt.model, ekey)
    inject(model, perm=perms, bernoulli=masks)
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    opt = trainer.init_opt_state(params)
    assert set(opt) == {"g", "d"}
    params, _, loss = model.run_epoch(params, opt, torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert_params_close(params, want, params_np)


def test_irgan_epoch_with_injected_jax_draws_matches_jax():
    jt, trainer = both_trainers("irgan")
    model, model_j = trainer.model, jt.model
    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, want, loss_j = jax_epoch(jt, params_np, 1)
    users = model_j._train_users
    # the D pass: negatives from the starting generator, the permutation
    k_neg, k_perm = jax.random.split(jax.random.fold_in(ekey, 0))
    g_logits = model_j._logits(jax.tree_util.tree_map(jnp.asarray, params_np["gen"]), users) / model_j.d_tau
    negs = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(model_j.L,)))(
        jax.random.split(k_neg, users.shape[0]), g_logits)
    n_pad = -(-(users.shape[0] * 2 * model_j.L) // model.batch_size) * model.batch_size
    inject(model, perm=[T(jax.random.permutation(k_perm, n_pad)).long()])
    # the G pass: one key a user, its sample drawn from the port's logits
    g_keys = iter(jax.random.split(jax.random.fold_in(ekey, 1000), users.shape[0]))
    d_negs = iter([T(negs).long()])

    def categorical(generator, logits, n):
        if logits.shape[0] > 1 or n == model.L:
            return next(d_negs)
        return T(jax.random.categorical(next(g_keys), jnp.asarray(logits[0].numpy()), shape=(n,)))[None].long()

    model._categorical = categorical
    params, loss = model.run_epoch(params_from_numpy(params_np, "cpu"), torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert_params_close(params, want, params_np)


def test_irgan_warm_starts_from_a_port_pickle(tmp_path):
    """An MF's factors, with a zero bias, in IRGAN's layout: both packages
    load the same generator and log the reference's line."""
    said = []

    class Lines(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    rng = np.random.RandomState(0)
    gen = {"user_emb": rng.randn(40, 4).astype(np.float32), "item_emb": rng.randn(60, 4).astype(np.float32),
           "item_bias": np.zeros(60, np.float32)}
    path = str(tmp_path / "irgan_gen.pkl")
    pretrain.save_pretrain("IRGAN", {"gen": params_from_numpy(gen, "cpu")}, path)
    handler = Lines()
    pretrain.log.addHandler(handler)
    try:
        _, _, model_j, model = build_both(dict(CONFS["irgan"], pretrain_file=path))
        params = model.init_params(torch.Generator().manual_seed(0))
    finally:
        pretrain.log.removeHandler(handler)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    for k, v in gen.items():
        np.testing.assert_array_equal(params["gen"][k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(params_j["gen"][k]), v)
    assert any(line.startswith("load pretrained params successful!") and path in line for line in said)


@pytest.mark.parametrize("name", ["pop", "itemknn"])
def test_none_epoch_evaluates_once_and_trains_nothing(name):
    conf = dict(CONFS[name], epochs=3)
    ds_j, ds, model_j, model = build_both(conf)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    assert trainer.steps == 0
    trainer.train_epoch = None  # a training epoch would fail
    result = trainer.train()
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger())
    np.testing.assert_allclose([float(x) for x in result.split("\t")],
                               [float(x) for x in jt.train().split("\t")], atol=1e-6)


def test_zero_epochs_evaluates_only():
    conf = dict(CONFS["multidae"], epochs=0)
    _, ds, _, model = build_both(conf)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    trainer.train_epoch = None
    assert len(trainer.train().split("\t")) == 4


def test_custom_epoch_comes_from_build_epoch():
    conf = dict(CONFS["jca"], epochs=2)
    _, ds, _, model = build_both(conf)
    calls = []
    real = model.build_epoch

    def build_epoch(trainer):
        assert trainer.model is model
        epoch_fn = real(trainer)

        def epoch(params, opt_state, generator, epoch, max_steps=None):
            calls.append(epoch)
            return epoch_fn(params, opt_state, generator, epoch, max_steps=2)

        return epoch

    model.build_epoch = build_epoch
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    trainer.train()
    assert calls == [1, 2]


@pytest.mark.parametrize("name, counted", [("jca", "step_loss"), ("multidae", "loss"), ("cfgan", "d_loss")])
def test_train_epoch_cuts_to_max_steps(name, counted):
    """``train_epoch(epoch, max_steps)`` takes the first steps of the
    epoch (of each pass of a custom epoch), the same as the whole epoch's
    first steps; ``None`` runs it whole."""
    _, ds, _, model = build_both(dict(CONFS[name]))
    trainer = Trainer(model, ds, DictConfig(CONFS[name]), logger=SilentLogger(), device="cpu")
    trainer.initialize()
    calls = []
    real = getattr(model, counted)
    setattr(model, counted, lambda *a, **k: calls.append(1) or real(*a, **k))
    trainer.params, trainer.opt_state, _ = trainer.train_epoch(1, max_steps=2)
    d_reps = model.step_D if name == "cfgan" else 1
    assert len(calls) == 2 * d_reps
    if name == "multidae":
        # the cut epoch is the whole epoch's first two steps
        again = Trainer(model, ds, DictConfig(CONFS[name]), logger=SilentLogger(), device="cpu")
        again.initialize()
        draws = again.draw_epoch(again.epoch_generator(1))
        params, _, _ = again.run_epoch(again.params, again.opt_state, *(a[:2] for a in draws), epoch=1)
        for (_, got), (_, want) in zip(param_leaves(trainer.params), param_leaves(params)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    calls.clear()
    trainer.train_epoch(2)
    assert len(calls) > 2 * d_reps


def test_exclusion_table_budget_binds_the_sampled_epochs_only(monkeypatch):
    from neurec_tpu_torch import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 16)
    for name in ("multidae", "wrmf", "pop"):
        _, ds, _, model = build_both(CONFS[name])
        trainer = Trainer(model, ds, DictConfig(CONFS[name]), logger=SilentLogger(), device="cpu")
        assert trainer._excl_bloom is None
    _, ds, _, model = build_both(CONFS["spectralcf"])
    trainer = Trainer(model, ds, DictConfig(CONFS["spectralcf"]), logger=SilentLogger(), device="cpu")
    assert trainer._excl_bloom is not None and not hasattr(trainer, "_padded_items")
    model.data_kind = "time_pairwise"  # the time-order epochs are sampled epochs too
    model.high_order = 1
    trainer = Trainer(model, ds, DictConfig(CONFS["spectralcf"]), logger=SilentLogger(), device="cpu")
    assert trainer._excl_bloom is not None and not hasattr(trainer, "_padded_items")


RUN_CASES = [
    ("Pop", []), ("ItemKNN", []), ("MultiDAE", []), ("MultiVAE", []), ("DAE", ["--hidden_neuron=8"]),
    ("CDAE", ["--hidden_dim=8"]), ("SpectralCF", ["--embedding_size=8"]), ("WRMF", []),
    ("JCA", ["--hidden_neuron=8"]),
    ("CFGAN", ["--hiddenLayer_G=[16]", "--hiddenLayer_D=[8]", "--batchSize_G=16", "--batchSize_D=16"]),
    ("IRGAN", ["--factors_num=4"]),
]


@pytest.mark.parametrize("name,extra", RUN_CASES)
def test_run_main_trains_and_evaluates_each_model(name, extra, tmp_path, monkeypatch):
    from neurec_tpu_torch import run

    monkeypatch.chdir(tmp_path)  # the run logger writes under ./log
    (tmp_path / "data").mkdir()
    _write_ratings(tmp_path / "data" / "syn.rating")
    args = ["--recommender=%s" % name, "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--data.input.path=%s" % (tmp_path / "data"), "--data.cache.path=%s" % (tmp_path / "cache"),
            "--data.input.dataset=syn", "--data.column.format=UIR", "--data.convert.separator=','",
            "--epochs=2", "--batch_size=16", "--topk=[5]", "--metric=[\"Recall\",\"NDCG\"]",
            "--pretrain_file="] + extra
    trainer, result = run.main(os.path.join(REPO, "NeuRec.properties"), args, device="cpu")
    values = [float(x) for x in result.split("\t")]
    assert len(values) == 2 and all(0.0 <= v <= 1.0 for v in values)
    records = list((tmp_path / "log" / "syn" / name).glob("*.log.metrics.jsonl"))
    if trainer.model.data_kind == "none":
        assert not records
        return
    losses = [float(line.split('"loss": ')[1].split(",")[0]) for line in records[0].read_text().splitlines()]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_k1_path_takes_f32_fmas_up_to_d40():
    assert [k1.k1_path(d) for d in (1, 16, 17, 21, 33, 40)] == ["fma"] * 6
    assert [k1.k1_path(d) for d in (41, 64, 65, 256, 300)] == ["split"] * 5
    with open(os.path.join(REPO, "neurec_tpu_torch", "csrc", "masked_scores.cu")) as fin:
        source = fin.read()
    bound = re.search(r"constexpr int FMA_MAX_D = (\d+);", source)
    assert bound and int(bound.group(1)) == k1.K1_FMA_MAX_D == 40
    # the entry picks the path from d alone, against that constant
    assert "if (d <= FMA_MAX_D) return" in source
