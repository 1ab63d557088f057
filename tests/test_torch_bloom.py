"""The pair Bloom sampler (``ops/bloom.py`` and the Trainer's branch over
``_EXCL_TABLE_BUDGET``) against the JAX package's, on the CPU.

* The table bytes equal the JAX build's, and the device membership equals
  the JAX probe's on 10^5 random pairs, negative ids included, at k 2, 3
  and 5 (integers: exact).
* No false negatives; a false-positive rate near the documented 3.1% at
  k = 3 (8 bits a pair), here under 5%.
* ``select_first_nonmember`` falls back to the round-0 draw.
* The Trainer takes the filter above the budget on the pairwise, pointwise
  and time-order epochs, and builds no padded table there; MF still learns.
* ``_bloom_rounds`` rises with the densest user (6 on sparse data, 16 for
  a user holding 45% of the catalogue), as in tests/test_heavy_tail.py.
* An epoch on the JAX pre-draw's own candidates (its chunk keys from
  ``fold_in(kn, steps)``): the same negatives, then the epoch loss to rtol
  2e-5 and the params to atol 2e-5, as the other epoch tests.
* The pre-draw's generator is seeded by a draw that the step seeds do not
  share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import neurec_tpu.trainer as jax_trainer_mod
from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.ops import bloom as jax_bloom
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch import trainer as trainer_mod
from neurec_tpu_torch.bridge import params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
from neurec_tpu_torch.ops import bloom
from neurec_tpu_torch.trainer import Trainer
from tests.test_heavy_tail import _zipf_interactions
from tests.test_torch_seq_models import CONFS as SEQ_CONFS
from tests.test_torch_seq_models import build_both as seq_build_both
from tests.test_torch_training import MF_PAIR, MF_POINT, SilentLogger, _both

torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("k_hash", [2, 3, 5])
def test_table_and_membership_equal_the_jax_filters(k_hash):
    rows, cols, U, I = _zipf_interactions(num_users=500, num_items=400)
    mine, theirs = bloom.build_pair_bloom(rows, cols, k_hash), jax_bloom.build_pair_bloom(rows, cols, k_hash)
    assert mine.n_bits == theirs.n_bits and mine.k_hash == theirs.k_hash == k_hash
    np.testing.assert_array_equal(mine.table, theirs.table)
    rng = np.random.RandomState(k_hash)
    qu = np.concatenate([rows[:2000], rng.randint(-U, U, 98_000)]).astype(np.int32)
    qi = np.concatenate([cols[:2000], rng.randint(-I, I, 98_000)]).astype(np.int32)
    got = bloom.is_positive_bloom(torch.from_numpy(mine.table), mine.n_bits, torch.from_numpy(qu),
                                  torch.from_numpy(qi)[:, None], k_hash)[:, 0].numpy()
    want = np.asarray(jax_bloom.is_positive_bloom(jnp.asarray(theirs.table), theirs.n_bits, jnp.asarray(qu),
                                                  jnp.asarray(qi)[:, None], k_hash))[:, 0]
    np.testing.assert_array_equal(got, want)
    assert got[:2000].all()


def test_no_false_negatives_and_the_documented_false_positive_rate():
    rows, cols, U, I = _zipf_interactions(num_users=500, num_items=400)
    bf = bloom.build_pair_bloom(rows, cols, k_hash=3)
    truth = set(zip(rows.tolist(), cols.tolist()))
    rng = np.random.RandomState(3)
    qu, qi = rng.randint(0, U, 20_000), rng.randint(0, I, 20_000)
    got = bloom.is_positive_bloom(torch.from_numpy(bf.table), bf.n_bits, torch.from_numpy(np.r_[rows, qu]),
                                  torch.from_numpy(np.r_[cols, qi])[:, None], 3)[:, 0].numpy()
    assert got[: len(rows)].all(), "a train pair was not flagged"
    want = np.array([(int(u), int(i)) in truth for u, i in zip(qu, qi)])
    fp_rate = float(got[len(rows):][~want].mean())
    assert 0.005 < fp_rate < 0.05, fp_rate
    assert bf.nbytes() <= 2 * len(rows)


def test_select_first_nonmember_and_the_round_zero_fallback():
    draws = torch.tensor([[5, 6, 7], [1, 2, 3], [9, 8, 4]], dtype=torch.int32)
    member = torch.tensor([[True, False, False], [True, True, True], [False, True, True]])
    np.testing.assert_array_equal(bloom.select_first_nonmember(draws, member).numpy(), [6, 1, 9])
    want = jax_bloom.select_first_nonmember(jnp.asarray(draws.numpy()), jnp.asarray(member.numpy()))
    np.testing.assert_array_equal(bloom.select_first_nonmember(draws, member).numpy(), np.asarray(want))


def test_sample_negatives_bloom_never_samples_positives():
    rows, cols, U, I = _zipf_interactions(num_users=200, num_items=2000, max_len=300)
    bf = bloom.build_pair_bloom(rows, cols)
    truth = set(zip(rows.tolist(), cols.tolist()))
    users = torch.arange(128) % U
    negs = bloom.sample_negatives_bloom(torch.Generator().manual_seed(5), users, torch.from_numpy(bf.table),
                                        bf.n_bits, I, (4,))
    assert negs.shape == (128, 4) and negs.dtype == torch.int32
    assert not any((int(u), int(i)) in truth for u, row in zip(users, negs) for i in row)


@pytest.mark.parametrize("case", ["mf-pairwise", "mf-pointwise", "fpmc-time_pairwise"])
def test_trainer_switches_to_the_bloom_filter_over_the_budget(monkeypatch, case):
    if case.startswith("fpmc"):
        conf = dict(SEQ_CONFS["fpmc-pair"], batch_size=64, learning_rate=0.05, topk=[10], metric=["Recall"])
        _, ds, _, model = seq_build_both(conf)
    else:
        conf = MF_PAIR if case == "mf-pairwise" else MF_POINT
        _, ds, _, model = _both(conf, seed=4)
    kind = case.split("-")[1]
    assert model.data_kind == kind
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    assert trainer._excl_bloom is None and trainer._padded_items is not None
    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 0)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    assert trainer._excl_bloom is not None and not hasattr(trainer, "_padded_items")
    assert trainer._excl_bloom[2] == 3 and 6 <= trainer._bloom_rounds <= 16
    trainer.initialize()
    draws = trainer.draw_epoch(trainer.epoch_generator(1))
    users = trainer._users_flat[trainer._base(draws.inst)]
    train = ds.train_matrix.tocsr()
    real = draws.w.numpy() > 0
    hits = train[users.numpy()[real], draws.negs.numpy()[real]]
    # a positive is kept only where every round was flagged (~(d + FP)^R)
    assert np.asarray(hits).sum() <= 0.01 * real.sum()
    losses = [float(trainer.train_epoch(e)[2]) for e in (1, 2, 3, 4)]
    assert np.isfinite(losses).all()
    if case == "mf-pairwise":
        assert losses[-1] < losses[0], losses


def test_bloom_binds_only_the_sampled_epochs(monkeypatch):
    from tests.test_torch_general_rest import CONFS, build_both

    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 16)
    for name in ("multidae", "wrmf", "pop"):
        _, ds, _, model = build_both(CONFS[name])
        assert Trainer(model, ds, DictConfig(CONFS[name]), logger=SilentLogger(), device="cpu")._excl_bloom is None


def rounds_for(rows, cols, U, I, monkeypatch):
    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 0)
    train = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(U, I))
    test = sp.csr_matrix(([1.0], ([0], [int(cols[0])])), shape=(U, I))
    ds = InMemoryDataset(train, test)
    conf = dict(MF_PAIR, batch_size=32, embedding_size=4)
    from neurec_tpu_torch.models import get_model

    model = get_model("MF")(ds, DictConfig(conf), device="cpu")
    return Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")._bloom_rounds


def test_bloom_rounds_scale_with_the_worst_density(monkeypatch):
    rng = np.random.RandomState(0)
    # sparse: 100 users x 10 items of 10,000
    assert rounds_for(np.repeat(np.arange(100), 10), rng.randint(0, 10_000, 1000), 100, 10_000, monkeypatch) == 6
    # one power user holding 45% of a small catalogue
    rows = np.concatenate([np.zeros(450, np.int64), np.arange(1, 50)])
    cols = np.concatenate([rng.permutation(1000)[:450], rng.randint(0, 1000, 49)])
    assert rounds_for(rows, cols, 50, 1000, monkeypatch) == 16
    # in between: the rule's least R with (d + FP)^R d / (d + FP) <= 1e-8
    d = 0.1
    r = trainer_mod._rounds_for(d)
    assert 6 < r < 16 and (d + 0.031) ** r * d / (d + 0.031) <= 1e-8 < (d + 0.031) ** (r - 1) * d / (d + 0.031)


def jax_predraw(jt, epoch):
    """The JAX trainer's epoch draws under the Bloom filter
    (neurec_tpu/trainer.py:284-300,399-412): the instances, the pre-draw
    users, each chunk's (C, R) candidates and the negatives it keeps."""
    model = jt.model
    B = model.batch_size
    N = int(jt._users_flat.shape[0])
    steps = -(-N // B)
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    inst = jnp.where(perm < N, perm, 0).astype(jnp.int32)
    w = (perm < N).astype(jnp.float32)
    users = jnp.asarray(jt._users_flat)[inst]
    table, n_bits, k_hash = jt._excl_bloom
    C, R = 8192, jt._bloom_rounds
    chunks = -(-users.shape[0] // C)
    u_pad = jnp.pad(users, (0, chunks * C - users.shape[0]))
    draws, negs = [], []
    for c, ku in enumerate(jax.random.split(jax.random.fold_in(kn, steps), chunks)):
        d = jax.random.randint(ku, (C, R), 0, model.num_items, dtype=jnp.int32)
        member = jax_bloom.is_positive_bloom(table, n_bits, u_pad[c * C:(c + 1) * C], d, k_hash)
        draws.append(torch.from_numpy(np.array(d)))
        negs.append(np.asarray(jax_bloom.select_first_nonmember(d, member)))
    return (ekey, np.array(inst).reshape(steps, B), np.array(w).reshape(steps, B),
            np.array(users), draws, np.concatenate(negs)[: users.shape[0]].reshape(steps, B))


def test_epoch_on_the_jax_predraw_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_trainer_mod, "_EXCL_TABLE_BUDGET", 0)
    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 0)
    conf = dict(MF_PAIR, batch_size=64)
    ds_j, ds, model_j, model = _both(conf, num_users=120, num_items=90, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    assert trainer._bloom_rounds == jt._bloom_rounds
    np.testing.assert_array_equal(trainer._excl_bloom[0].numpy(), np.asarray(jt._excl_bloom[0]))
    ekey, inst, w, users, draws, negs_j = jax_predraw(jt, epoch=3)
    it = iter(draws)
    trainer._bloom_draws = lambda generator, shape: next(it)
    negs = trainer.bloom_negatives(torch.Generator(), torch.from_numpy(users).long())
    np.testing.assert_array_equal(negs.numpy(), negs_j.reshape(-1))

    rng = np.random.RandomState(5)
    params_np = {"user_emb": rng.uniform(-0.3, 0.3, (model.num_users, 8)).astype(np.float32),
                 "item_emb": rng.uniform(-0.3, 0.3, (model.num_items, 8)).astype(np.float32)}
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(3))
    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(params_np, "cpu").items()}
    params, _, loss = trainer.run_epoch(params, trainer.init_opt_state(params), torch.from_numpy(inst),
                                        torch.from_numpy(w), negs.reshape(inst.shape), epoch=3)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-5)
    got = params_to_numpy(params)
    for k in params_np:
        np.testing.assert_allclose(got[k], np.asarray(params_j[k]), atol=2e-5, err_msg=k)


def test_the_predraw_generator_is_not_a_step_stream(monkeypatch):
    monkeypatch.setattr(trainer_mod, "_EXCL_TABLE_BUDGET", 0)
    _, ds, _, model = _both(MF_PAIR, seed=4)
    trainer = Trainer(model, ds, DictConfig(MF_PAIR), logger=SilentLogger(), device="cpu")
    seen = []
    real = trainer.bloom_negatives

    def spy(generator, users):
        seen.append(generator.initial_seed())
        return real(generator, users)

    trainer.bloom_negatives = spy
    draws = trainer.draw_epoch(trainer.epoch_generator(2))
    assert len(seen) == 1 and seen[0] not in set(draws.seeds.tolist())
    assert seen[0] != trainer.epoch_generator(2).initial_seed()
    # the same epoch draws the same negatives
    again = trainer.draw_epoch(trainer.epoch_generator(2))
    assert torch.equal(draws.negs, again.negs) and torch.equal(draws.inst, again.inst)
