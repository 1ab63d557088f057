"""The sequential slice's data, time-order epochs and building blocks
against the JAX package's, on the CPU.

* ``pad_sequences`` on every pad / truncate mode, ``user_seq_windows``,
  ``build_padded_bytime`` and ``SequentialMixin._setup_recent``: the JAX
  package's arrays bit for bit.
* The ``time_pairwise`` / ``time_pointwise`` epochs: the instances (user,
  recent items, target) and each batch's ``recent_items`` on the JAX
  epoch's permutation and negatives, and one epoch on those draws: the
  loss to rtol 2e-5 and the params after it to atol 2e-5.
* ``Trainer`` builds a time epoch, and the exclusion-table budget binds it:
  above it the trainer raises, naming the Bloom sampler.
* ``_gru_step`` against the JAX one, and not ``torch.nn.GRUCell`` on the
  same weights (the reset gate goes before the candidate's product);
  ``ops/attention.py`` against the JAX one with padded keys and queries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu.data.padded import build_padded_bytime as jax_build_padded_bytime
from neurec_tpu.data.sequences import pad_sequences as jax_pad_sequences
from neurec_tpu.data.sequences import user_seq_windows as jax_user_seq_windows
from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.models.sequential.gru4rec import _gru_step as jax_gru_step
from neurec_tpu.ops import attention as jax_attention
from neurec_tpu.ops.sampling import sample_negatives as jax_sample_negatives
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import map_params, param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.padded import build_padded_bytime
from neurec_tpu_torch.data.sequences import pad_sequences, user_seq_windows
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.sequential.gru4rec import _gru_step
from neurec_tpu_torch.ops import attention
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_seq_models import CONFS, build_both, numpy_params
from tests.test_torch_training import SilentLogger

torch.set_float32_matmul_precision("highest")

SEQS = [[3, 1, 4, 1, 5], [], [9, 2], [6, 5, 3, 5, 8, 9, 7, 9]]


@pytest.mark.parametrize("padding", ["pre", "post"])
@pytest.mark.parametrize("truncating", ["pre", "post"])
@pytest.mark.parametrize("max_len", [None, 3, 6])
def test_pad_sequences_matches_jax(padding, truncating, max_len):
    got = pad_sequences(SEQS, value=-1, max_len=max_len, padding=padding, truncating=truncating)
    want = jax_pad_sequences(SEQS, value=-1, max_len=max_len, padding=padding, truncating=truncating)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pad_sequences_refuses_unknown_modes():
    with pytest.raises(ValueError, match="padding"):
        pad_sequences(SEQS, max_len=9, padding="middle")
    with pytest.raises(ValueError, match="truncating"):
        pad_sequences(SEQS, max_len=2, truncating="middle")


@pytest.mark.parametrize("high_order", [1, 2, 3])
def test_user_seq_windows_match_jax(high_order):
    for got, want in zip(user_seq_windows(SEQS, high_order), jax_user_seq_windows(SEQS, high_order)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _time_matrix(seed=0, shape=(7, 12)):
    """Random times with ties (stable order) and a user without items."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(*shape) < 0.5) * rng.randint(1, 4, shape).astype(np.float32)
    dense[2] = 0
    return sp.csr_matrix(dense)


def test_build_padded_bytime_matches_jax():
    tm = _time_matrix()
    got, want = build_padded_bytime(tm, tm), jax_build_padded_bytime(tm, tm)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.num_items == want.num_items == 12 and got.max_len == want.max_len == 8 * -(-got.lengths.max() // 8)
    assert (got.items[2] == 12).all()


@pytest.mark.parametrize("name", ["fpmc", "npe", "fossil"])
def test_setup_recent_matches_jax(name):
    _, _, model_j, model = build_both(CONFS[name])
    assert model._recent_items.shape == (model.num_users, model.high_order)
    np.testing.assert_array_equal(model._recent_items.numpy(), np.asarray(model_j._recent_items))
    np.testing.assert_array_equal(model._has_history.numpy(), np.asarray(model_j._has_history))


def test_setup_recent_left_pads_a_short_history():
    train = sp.csr_matrix(np.array([[1, 1, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0]], np.float32))
    times = sp.csr_matrix(np.array([[2, 1, 0, 0], [0, 0, 0, 5], [0, 0, 0, 0]], np.float32))
    ds = InMemoryDataset(train, sp.csr_matrix((3, 4), dtype=np.float32), times)
    model = get_model("NPE")(ds, DictConfig(CONFS["npe"]), device="cpu")
    np.testing.assert_array_equal(model._recent_items.numpy(), [[1, 1, 0], [3, 3, 3], [0, 0, 0]])
    np.testing.assert_array_equal(model._has_history.numpy(), [True, True, False])


def _jax_time_epoch_draws(jt, epoch):
    """The JAX time-order epoch's draws, rebuilt outside its jitted scan
    (neurec_tpu/trainer.py:399-404, :345-347 and :366-389)."""
    model = jt.model
    B = model.batch_size
    users_flat = jnp.asarray(jt._users_flat)
    N = int(users_flat.shape[0])
    pairwise = model.data_kind == "time_pairwise"
    n_inst = N if pairwise else N * (1 + model.num_negatives)
    steps = -(-n_inst // B)
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    inst = jnp.where(perm < n_inst, perm, 0).astype(jnp.int32).reshape(steps, B)
    w = (perm < n_inst).astype(jnp.float32).reshape(steps, B)
    negs = []
    for s, key in enumerate(jax.random.split(kn, steps)):
        k_neg, _ = jax.random.split(key)
        base = inst[s] if pairwise else inst[s] % N
        negs.append(jax_sample_negatives(k_neg, jt._padded_items[users_flat[base]], model.num_items, ()))
    return ekey, np.array(inst), np.array(w), np.array(jnp.stack(negs))


TIME_CASES = ["fpmc", "fpmc-pair", "fpmcplus", "transrec", "fossil", "fossil-pair", "hrm", "npe"]


def both_trainers(name, seed=4, **over):
    conf = dict(CONFS[name], **over)
    ds_j, ds, model_j, model = build_both(conf, seed=seed)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    return jt, trainer


@pytest.mark.parametrize("name", ["fpmc", "fpmcplus", "npe"])
def test_time_order_instances_and_batches_match_jax(name):
    jt, trainer = both_trainers(name)
    model = trainer.model
    assert model.data_kind == jt.model.data_kind and model.data_kind.startswith("time_")
    np.testing.assert_array_equal(trainer._users_flat.numpy(), jt._users_flat)
    np.testing.assert_array_equal(trainer._pos_flat.numpy(), jt._pos_flat)
    np.testing.assert_array_equal(trainer._recent_flat.numpy(), jt._recent_flat)
    assert trainer._recent_flat.shape == (trainer.n_positives, model.high_order)
    _, inst, w, negs = _jax_time_epoch_draws(jt, epoch=2)
    assert inst.shape == (trainer.steps, model.batch_size)
    N = trainer.n_positives
    for s in range(inst.shape[0]):
        batch = trainer._batch(torch.from_numpy(inst[s]), torch.from_numpy(negs[s]))
        base = inst[s] if model.data_kind == "time_pairwise" else inst[s] % N
        np.testing.assert_array_equal(batch["recent_items"].numpy(), jt._recent_flat[base])
        np.testing.assert_array_equal(batch["users"].numpy(), jt._users_flat[base])
        if model.data_kind == "time_pointwise":
            np.testing.assert_array_equal(batch["labels"].numpy(), (inst[s] < N).astype(np.float32))
            np.testing.assert_array_equal(batch["items"].numpy(),
                                          np.where(inst[s] < N, jt._pos_flat[base], negs[s]))


# Fossil's pointwise set less the target adds +g and -g to the target's row
# of P, which cancel in exact arithmetic; each package leaves its own f32
# residue (~1e-9) there, and Adam turns a residue into a step of up to lr.
# Its epoch runs under plain gradient descent, where the params agree to 1e-8.
EPOCH_OVERRIDES = {"fossil": {"learner": "gd", "learning_rate": 0.05}}


@pytest.mark.parametrize("name", TIME_CASES)
def test_time_epoch_with_injected_jax_draws_matches_jax(name):
    jt, trainer = both_trainers(name, **EPOCH_OVERRIDES.get(name, {}))
    model = trainer.model
    params_np = numpy_params(jt.model, 5, scale=0.3)
    ekey, inst, w, negs = _jax_time_epoch_draws(jt, epoch=3)
    assert (w == 0).any()
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(3))
    params = map_params(lambda t: t.requires_grad_(True), params_from_numpy(params_np, "cpu"))
    params, _, loss = trainer.run_epoch(params, trainer.init_opt_state(params), torch.from_numpy(inst),
                                        torch.from_numpy(w), torch.from_numpy(negs), epoch=3)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-5)
    want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    moved = False
    for path, p in param_leaves(params_to_numpy(params)):
        np.testing.assert_allclose(p, want[path], atol=2e-5, err_msg=str(path))
        moved |= not np.allclose(p, params_np[path[0]])
    assert moved


def test_time_epoch_builds_and_the_budget_binds_it(monkeypatch):
    """A time epoch draws and trains through ``Trainer``; above the
    exclusion-table budget it excludes through the pair Bloom filter, as
    the sampled epochs do, and builds no padded table."""
    from neurec_tpu_torch import trainer as trainer_mod

    _, trainer = both_trainers("fpmc-pair")
    trainer.initialize()
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    trainer.params, trainer.opt_state, loss = trainer.train_epoch(1)
    assert np.isfinite(float(loss)) and trainer.steps > 1
    assert any(not torch.equal(before[k], trainer.params[k]) for k in before)
    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 16)
    for name in ("fpmc", "fpmc-pair"):
        _, ds, _, model = build_both(CONFS[name])
        bloom = Trainer(model, ds, DictConfig(CONFS[name]), logger=SilentLogger(), device="cpu")
        assert bloom._excl_bloom is not None and not hasattr(bloom, "_padded_items")


def test_trainer_refuses_an_unknown_data_kind():
    _, ds, _, model = build_both(CONFS["npe"])
    model.data_kind = "time_listwise"
    with pytest.raises(ValueError, match="time_listwise"):
        Trainer(model, ds, DictConfig(CONFS["npe"]), logger=SilentLogger(), device="cpu")


def test_gru_step_matches_jax_and_is_not_torch_grucell():
    rng = np.random.RandomState(0)
    B, d_in, units = 6, 5, 4
    cell = {"w_gate": rng.randn(d_in + units, 2 * units).astype(np.float32) * 0.5,
            "b_gate": rng.randn(2 * units).astype(np.float32), "w_cand": rng.randn(d_in + units, units).astype(
                np.float32) * 0.5, "b_cand": rng.randn(units).astype(np.float32)}
    x, h = rng.randn(B, d_in).astype(np.float32), rng.randn(B, units).astype(np.float32)
    for act, act_j in ((torch.tanh, jnp.tanh), (torch.relu, jax.nn.relu)):
        want = np.asarray(jax_gru_step({k: jnp.asarray(v) for k, v in cell.items()}, act_j, jnp.asarray(x),
                                       jnp.asarray(h)))
        got = _gru_step(params_from_numpy(cell, "cpu"), act, torch.from_numpy(x), torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # torch.nn.GRUCell on the same weights: r * (W_hn h + b_hn) after the
    # product, the gate order (r, z, n) and z weighting h as u does
    gru = torch.nn.GRUCell(d_in, units)
    wg, wc = torch.from_numpy(cell["w_gate"]), torch.from_numpy(cell["w_cand"])
    with torch.no_grad():
        gru.weight_ih.copy_(torch.cat([wg[:d_in].T, wc[:d_in].T]))
        gru.weight_hh.copy_(torch.cat([wg[d_in:].T, wc[d_in:].T]))
        gru.bias_ih.copy_(torch.cat([torch.from_numpy(cell["b_gate"]), torch.from_numpy(cell["b_cand"])]))
        gru.bias_hh.zero_()
        other = gru(torch.from_numpy(x), torch.from_numpy(h))
        ours = _gru_step(params_from_numpy(cell, "cpu"), torch.tanh, torch.from_numpy(x), torch.from_numpy(h))
    assert float((other - ours).abs().max()) > 1e-2
    # with the state at zero the two agree: the difference is r's place
    with torch.no_grad():
        zero = torch.zeros(B, units)
        np.testing.assert_allclose(gru(torch.from_numpy(x), zero).numpy(),
                                   _gru_step(params_from_numpy(cell, "cpu"), torch.tanh, torch.from_numpy(x),
                                             zero).numpy(), rtol=1e-5, atol=1e-6)


def _block_params(rng, d):
    dense = lambda: {"w": rng.randn(d, d).astype(np.float32) * 0.3, "b": rng.randn(d).astype(np.float32) * 0.1}  # noqa
    return {"att": {"q": dense(), "k": dense(), "v": dense()}, "ffn": {"w1": dense(), "w2": dense()},
            "ln": {"gamma": 1 + rng.randn(d).astype(np.float32) * 0.1, "beta": rng.randn(d).astype(np.float32)}}


@pytest.mark.parametrize("num_heads", [1, 2])
def test_attention_block_matches_jax_with_padding(num_heads):
    rng = np.random.RandomState(num_heads)
    B, T, d = 4, 6, 8
    blk = _block_params(rng, d)
    x = rng.randn(B, T, d).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[0, :3] = 0  # pre-padded keys and queries
    valid[2, :5] = 0
    blk_j = jax.tree_util.tree_map(jnp.asarray, blk)
    q_j = jax_attention.layer_norm(blk_j["ln"], jnp.asarray(x))
    att_j = jax_attention.multihead_attention(blk_j["att"], q_j, jnp.asarray(x), jnp.asarray(valid), num_heads)
    out_j = jax_attention.feedforward(blk_j["ffn"], jax_attention.layer_norm(blk_j["ln"], att_j))
    blk_t = params_from_numpy(blk, "cpu")
    q = attention.layer_norm(blk_t["ln"], torch.from_numpy(x))
    att = attention.multihead_attention(blk_t["att"], q, torch.from_numpy(x), torch.from_numpy(valid), num_heads)
    out = attention.feedforward(blk_t["ffn"], attention.layer_norm(blk_t["ln"], att))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(att.numpy(), np.asarray(att_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    # a padded query's attention output is its residual alone
    np.testing.assert_allclose(att[0, :3].numpy(), q[0, :3].numpy(), rtol=0, atol=0)
    assert attention._NEG == jax_attention._NEG == -(2.0 ** 32) + 1.0


@pytest.mark.parametrize("max_seq_len", [3, 8, 200])
def test_srgnn_instances_gathered_on_the_device_match_jax(max_seq_len):
    """SRGNN's training contexts, gathered per batch from the users'
    sequences, equal the JAX package's padded tables (every suffix target,
    the last max_len items before it, post-padded), and so do its
    evaluation sessions."""
    _, _, model_j, model = build_both(dict(CONFS["srgnn"], max_seq_len=max_seq_len))
    assert (model._n_inst, model._max_len) == (model_j._n_inst, model_j._max_len)
    seq, sess_len, tar = model.instances(torch.arange(model._n_inst))
    for got, want in ((seq, model_j._seq), (sess_len, model_j._seq_len), (tar, model_j._tar),
                      (model._eval_seq, model_j._eval_seq), (model._eval_len, model_j._eval_len)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
