"""The sequential custom epochs (SASRec, Caser, GRU4Rec, GRU4RecPlus,
SRGNN) against the JAX package's, on the CPU, and the JAX package's own
sequential regressions mirrored on the port.

* One epoch on the JAX epoch's own draws, rebuilt from its key schedule
  (neurec_tpu/models/sequential/sasrec.py:205-222, caser.py:171-190,
  gru4rec.py:303-330, srgnn.py:207-235) and handed to the port's draw
  methods: the permutations, the negatives, the dropout masks, GRU4Rec's
  session order and GRU4RecPlus's uniform draws. The epoch loss to rtol
  2e-5 and the params after it to atol 2e-5.
* GRU4Rec: the schedule against the lock-step oracle of
  tests/test_sequential_models.py at batch 1, 4, 7 and 32; an epoch ends in
  pad steps, which change nothing (the Adam step count is the number of
  steps with a valid entry, and a schedule of pad steps alone leaves the
  params and the optimizer as they were).
* GRU4RecPlus's bpr-max and top1-max against a numpy transcription of the
  reference's (GRU4RecPlus.py:93-121).
* SRGNN on data smaller than one batch trains one batch; its Adam decays
  the lr as optax's staircase exponential decay does.
* Caser ranks without the item bias.
* ``run.main`` trains and evaluates each of the 11 sequential models for
  one epoch on a seeded UIRT file (loo split by time).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.ops.sampling import sample_negatives as jax_sample_negatives
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.sequential.gru4recplus import GRU4RecPlus
from neurec_tpu_torch.trainer import Trainer
from tests.test_sequential_models import _lockstep_schedule_oracle
from tests.test_torch_seq_models import CONFS, T, build_both, inject, numpy_params, sasrec_masks
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both_trainers(name, **over):
    conf = dict(CONFS[name], **over)
    ds_j, ds, model_j, model = build_both(conf, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    trainer.initialize()
    return jt, trainer


def jax_epoch(jt, params_np, epoch):
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, opt_j, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(epoch))
    return ekey, jax.tree_util.tree_map(np.asarray, params_j), float(loss_j), opt_j


def trainable(params_np):
    params = params_from_numpy(params_np, "cpu")
    for _, p in param_leaves(params):
        p.requires_grad_(True)
    return params


def assert_params_close(params, want, start, atol=2e-5, exempt=()):
    want, start = dict(param_leaves(want)), dict(param_leaves(start))
    moved = False
    for path, p in param_leaves(params_to_numpy(params)):
        if path[-3:] in exempt:
            continue
        np.testing.assert_allclose(p, want[path], atol=atol, err_msg=str(path))
        moved |= not np.allclose(p, start[path])
    assert moved


def jax_step_draws(model_j, jt, ekey, n_rows, neg_shape, masks):
    """The permutation and each step's negatives and dropout masks of the
    SASRec / Caser epoch: ``split(ekey)`` -> (permutation key, step keys),
    each step key split into (negatives, dropout)."""
    B = model_j.batch_size
    steps = -(-n_rows // B)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    idx = jnp.where(perm < n_rows, perm, 0).reshape(steps, B)
    negs, drops = [], []
    for s, key in enumerate(jax.random.split(kn, steps)):
        k_neg, k_drop = jax.random.split(key)
        users = model_j._train_users[idx[s]] if hasattr(model_j, "_train_users") else model_j._users[idx[s]]
        negs.append(T(jax_sample_negatives(k_neg, jt._padded_items[users], model_j.num_items, neg_shape)).long())
        drops += masks(k_drop, idx[s])
    return [T(perm).long()], negs, drops


def test_sasrec_epoch_with_injected_jax_draws_matches_jax():
    jt, trainer = both_trainers("sasrec")
    model, model_j = trainer.model, jt.model
    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, want, loss_j, _ = jax_epoch(jt, params_np, 1)
    perm, negs, drops = jax_step_draws(model_j, jt, ekey, int(model_j._train_users.shape[0]), (model.max_len,),
                                       lambda k, idx: sasrec_masks(model_j, k, idx.shape[0], model.max_len))
    inject(model, perm=perm, negatives=negs, bernoulli=drops)
    params = trainable(params_np)
    params, _, loss = model.run_epoch(params, trainer.init_opt_state(params), torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=2e-5)
    # the key bias adds q.b_k to every logit of a query, which the softmax
    # removes: its gradient is zero in exact arithmetic, f32 residue in
    # either package, which Adam turns into steps of up to lr. It is held
    # to the loss instead, which it does not move.
    assert_params_close(params, want, params_np, exempt={("att", "k", "b")})


def test_caser_epoch_with_injected_jax_draws_matches_jax():
    jt, trainer = both_trainers("caser")
    model, model_j = trainer.model, jt.model
    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, want, loss_j, _ = jax_epoch(jt, params_np, 1)
    out_dim = model.nv * model.d + model.nh * model.L
    perm, negs, drops = jax_step_draws(
        model_j, jt, ekey, int(model_j._users.shape[0]), (model.neg_samples,),
        lambda k, idx: [T(jax.random.bernoulli(k, 1.0 - model.dropout, (idx.shape[0], out_dim)))])
    inject(model, perm=perm, negatives=negs, bernoulli=drops)
    params = trainable(params_np)
    params, _, loss = model.run_epoch(params, trainer.init_opt_state(params), torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=2e-5)
    assert_params_close(params, want, params_np)


def jax_session_order(model_j, ekey):
    seed = int(jax.random.randint(ekey, (), 0, 2 ** 31 - 1))
    return np.random.RandomState(seed).permutation(model_j.num_users)


@pytest.mark.parametrize("name", ["gru4rec", "gru4rec-bpr", "gru4recplus", "gru4recplus-top1"])
def test_gru4rec_epoch_with_injected_jax_draws_matches_jax(name):
    jt, trainer = both_trainers(name)
    model, model_j = trainer.model, jt.model
    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, want, loss_j, _ = jax_epoch(jt, params_np, 1)
    order = jax_session_order(model_j, ekey)
    draws = {"session_order": [order]}
    if model.name == "GRU4RecPlus":
        keys = jax.random.split(ekey, model_j._sched_len)
        draws["uniform"] = [T(jax.random.uniform(k, (model.n_sample,))) for k in keys]
    inject(model, **draws)
    params = trainable(params_np)
    schedule = model.schedule(torch.Generator())
    assert schedule[0].shape[0] == model._sched_len == model_j._sched_len
    assert not schedule[3][-1].any()  # the epoch ends in pad steps
    params, _, loss = model.run_schedule(params, trainer.init_opt_state(params), *schedule, torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=2e-5)
    assert_params_close(params, want, params_np)


def test_srgnn_epoch_with_injected_jax_draws_matches_jax():
    jt, trainer = both_trainers("srgnn")
    model, model_j = trainer.model, jt.model
    params_np = numpy_params(model_j, 5, scale=0.3)
    ekey, want, loss_j, _ = jax_epoch(jt, params_np, 1)
    inject(model, perm=[T(jax.random.permutation(ekey, model._n_inst)).long()])
    params = trainable(params_np)
    params, _, loss = model.run_epoch(params, trainer.init_opt_state(params), torch.Generator())
    np.testing.assert_allclose(float(loss), loss_j, rtol=2e-5)
    assert_params_close(params, want, params_np)


def test_srgnn_lr_decays_as_optax_staircase():
    """lr_dc_step 1 on the test data: the decay comes every N / B steps."""
    _, trainer = both_trainers("srgnn")
    model = trainer.model
    transition = max(int(model.lr_dc_step * model._n_inst / model.batch_size), 1)
    sched = optax.exponential_decay(model.lr, transition, model.lr_dc, staircase=True)
    opt = trainer.opt_state
    seen = []
    for _ in range(2 * transition + 1):
        opt.zero_grad(set_to_none=True)
        model.batch_loss(trainer.params, torch.arange(model.batch_size)).backward()
        count = len(seen)
        opt.step()
        seen.append(opt.param_groups[0]["lr"])
        assert seen[-1] == pytest.approx(float(sched(count)), rel=1e-7)
    assert seen[0] == pytest.approx(model.lr, rel=1e-7)
    assert seen[-1] == pytest.approx(model.lr * model.lr_dc ** 2, rel=1e-6)


@pytest.mark.parametrize("batch", [1, 4, 7, 32])
def test_gru4rec_schedule_matches_lockstep_oracle(batch):
    _, ds, _, model = build_both(dict(CONFS["gru4rec"], batch_size=batch), seed=2)
    rng = np.random.RandomState(7)
    for _ in range(3):
        perm = rng.permutation(model.num_users)
        got = model._build_schedule(perm, batch)
        want = _lockstep_schedule_oracle(model._user_seqs, perm, batch)
        for g, w, name in zip(got, want, ("in", "out", "reset", "valid")):
            if name == "reset":  # a dead stream's reset changes nothing
                live = want[3]
                np.testing.assert_array_equal(g & live, w & live, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert model._pin_sched_len(batch) >= got[0].shape[0] and model._pin_sched_len(batch) % 128 == 0


@pytest.mark.parametrize("name", ["gru4rec", "gru4recplus"])
def test_gru4rec_pad_steps_do_not_update(name):
    """The pinned schedule's all-invalid tail steps are true no-ops: the
    Adam step count after an epoch is the number of steps with a valid
    entry, not the pinned length, and pad steps alone leave the params and
    the optimizer state bit for bit."""
    _, trainer = both_trainers(name)
    model = trainer.model
    inject(model, session_order=[np.arange(model.num_users)] * 2)
    schedule = model.schedule(torch.Generator())
    n_live = int(schedule[3].any(axis=1).sum())
    assert model._sched_len > n_live
    trainer.params, trainer.opt_state, loss = trainer.train_epoch(1)
    counts = {int(s["step"]) for s in trainer.opt_state.state.values()}
    assert counts == {n_live} and np.isfinite(float(loss))
    before = {path: p.detach().clone() for path, p in param_leaves(trainer.params)}
    state = {k: v.clone() for s in trainer.opt_state.state.values() for k, v in s.items() if k != "step"}
    pads = tuple(a[-3:] for a in schedule)
    assert not pads[3].any()
    _, _, pad_loss = model.run_schedule(trainer.params, trainer.opt_state, *pads, torch.Generator())
    assert float(pad_loss) == 0.0
    for path, p in param_leaves(trainer.params):
        assert torch.equal(p, before[path]), path
    assert {int(s["step"]) for s in trainer.opt_state.state.values()} == {n_live}
    after = {k: v for s in trainer.opt_state.state.values() for k, v in s.items() if k != "step"}
    assert all(torch.equal(after[k], state[k]) for k in state)


def test_gru4recplus_losses_match_reference_math():
    """bpr-max / top1-max against a literal numpy transcription of the
    reference's _softmax_neg / _bpr_max_loss / _top1_max_loss
    (GRU4RecPlus.py:93-121), every row and column valid."""
    rng = np.random.RandomState(0)
    B, n_extra = 12, 7
    C = B + n_extra
    logits = rng.standard_normal((B, C)).astype(np.float32)
    hm = 1.0 - np.eye(B, C)
    x = logits * hm
    e_x = np.exp(x - x.max(axis=1, keepdims=True)) * hm
    sm = e_x / e_x.sum(axis=1, keepdims=True)
    pos = np.diag(logits[:, :B])[:, None]
    prob = 1.0 / (1.0 + np.exp(-(pos - logits)))
    want_bpr = np.mean(-np.log((prob * sm).sum(axis=1) + 1e-24) + (np.square(logits) * sm).sum(axis=1))
    prob_t = 1.0 / (1.0 + np.exp(pos - logits)) + 1.0 / (1.0 + np.exp(-np.square(logits)))
    want_top1 = np.mean((prob_t * sm).sum(axis=1))
    model = types.SimpleNamespace(bpr_reg=1.0, _softmax_neg=GRU4RecPlus._softmax_neg)
    for loss_name, want in (("bpr_max", want_bpr), ("top1_max", want_top1)):
        model.loss_name = loss_name
        got = GRU4RecPlus._loss_from_logits(model, torch.from_numpy(logits), torch.ones(B), torch.ones(C), B)
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_gru4recplus_extra_negatives_follow_the_popularity_cdf():
    _, _, _, model = build_both(CONFS["gru4recplus"])
    inject(model, uniform=[torch.tensor([0.0, 1e-9, 0.5, 0.999999, 1.0])])
    got = model._extra_negatives(None)
    want = np.minimum(np.searchsorted(model._pop_cumsum.numpy(), [0.0, 1e-9, 0.5, 0.999999, 1.0]),
                      model.num_items - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_srgnn_dataset_smaller_than_batch():
    """Fewer instances than one batch: the batch clamps to N and one full
    batch trains (the JAX package's fix, neurec_tpu/models/sequential/
    srgnn.py:209)."""
    ds = random_dataset(num_users=6, num_items=20, min_per_user=6, max_per_user=9, seed=3)
    conf = DictConfig(dict(CONFS["srgnn"], batch_size=512, epochs=1, verbose=1))
    model = get_model("SRGNN")(ds, conf, device="cpu")
    assert model._n_inst < 512
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), device="cpu")
    trainer.initialize()
    seen = []
    real = model.batch_loss
    model.batch_loss = lambda params, idx: seen.append(idx.shape[0]) or real(params, idx)
    vals = [float(x) for x in trainer.train().split("\t")]
    assert seen == [model._n_inst]
    assert len(vals) == 4 and all(np.isfinite(vals))


def test_caser_eval_scores_without_item_bias():
    """The reference's quirk (Caser.py:122): the item bias enters the
    training logits, not the evaluation's."""
    _, _, model_j, model = build_both(CONFS["caser"])
    params = params_from_numpy(numpy_params(model_j, 0), "cpu")
    users = torch.arange(5)
    with torch.no_grad():
        base = model.predict(params, users)
        shifted = model.predict(dict(params, item_bias=params["item_bias"] + 1e3), users)
        u, items = model.eval_embeddings(params, users)
    torch.testing.assert_close(base, shifted, rtol=0, atol=0)
    assert u.shape[1] == items.shape[1] == 2 * model.d


def _write_uirt(path, seed=0, n_users=40, n_items=60):
    rng = np.random.RandomState(seed)
    lines = []
    for u in range(n_users):
        items = rng.choice(n_items, rng.randint(5, 16), replace=False)
        lines += ["%d,%d,1,%d" % (u, i, 1000 + t) for t, i in enumerate(items)]
    path.write_text("\n".join(lines) + "\n")


RUN_CASES = [
    ("FPMC", ["--embedding_size=8"]), ("FPMCplus", ["--embedding_size=8", "--weight_size=4"]),
    ("TransRec", ["--embedding_size=8"]), ("Fossil", ["--embedding_size=8"]), ("HRM", ["--embedding_size=8"]),
    ("NPE", ["--embedding_size=8"]), ("SASRec", ["--hidden_units=8", "--max_len=8", "--num_blocks=1"]),
    ("Caser", ["--factors_num=8", "--nh=4"]), ("GRU4Rec", ["--layers=[8]", "--batch_size=16"]),
    ("GRU4RecPlus", ["--layers=[8]", "--batch_size=16", "--n_sample=32"]),
    ("SRGNN", ["--hidden_size=8", "--max_seq_len=8"]),
]


@pytest.mark.parametrize("name,extra", RUN_CASES)
def test_run_main_trains_and_evaluates_each_model(name, extra, tmp_path, monkeypatch):
    from neurec_tpu_torch import run

    monkeypatch.chdir(tmp_path)  # the run logger writes under ./log
    (tmp_path / "data").mkdir()
    _write_uirt(tmp_path / "data" / "seq.rating")
    args = ["--recommender=%s" % name, "--config_dir=%s" % os.path.join(REPO, "conf"),
            "--data.input.path=%s" % (tmp_path / "data"), "--data.cache.path=%s" % (tmp_path / "cache"),
            "--data.input.dataset=seq", "--data.column.format=UIRT", "--data.convert.separator=','",
            "--splitter=loo", "--by_time=True", "--user_min=0", "--item_min=0", "--epochs=1", "--topk=[5]",
            "--metric=[\"Recall\",\"NDCG\"]"] + extra
    trainer, result = run.main(os.path.join(REPO, "NeuRec.properties"), args, device="cpu")
    values = [float(x) for x in result.split("\t")]
    assert len(values) == 2 and all(0.0 <= v <= 1.0 for v in values)
    assert trainer.model.name == name
    records = list((tmp_path / "log" / "seq" / name).glob("*.log.metrics.jsonl"))
    assert len(records) == 1
    losses = [float(line.split('"loss": ')[1].split(",")[0]) for line in records[0].read_text().splitlines()]
    assert len(losses) == 1 and np.isfinite(losses).all()
