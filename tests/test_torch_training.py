"""The training slice: the port's model losses, gradients and epochs
against the JAX package's, on the CPU.

* One batch (some weights 0): the same ``loss`` value and parameter
  gradients as ``jax.value_and_grad(model.loss)``, to rtol 1e-5 / atol
  1e-6 (f32, other summation orders). LightGCN also runs on a graph above
  ``DENSE_LIMIT`` with the non-symmetric ``gcmc`` adjacency, so that the
  port takes ``PlanSpmm`` and its backward over the transposed plan.
* One epoch with the JAX epoch's own draws, rebuilt as
  ``neurec_tpu/trainer.py`` makes them (``fold_in(PRNGKey(seed + 1),
  epoch)``, split, permutation, step keys, ``sample_negatives`` per step)
  and fed to the port's ``run_epoch``: the epoch loss to rtol 1e-5 and the
  params after the epoch to atol 2e-5 (Adam steps of lr 0.05 magnify the
  gradients' f32 noise, and optax's f32 bias correction differs from
  torch's by ~2e-5 of a step, see test_torch_optim.py).
* ``Trainer.train`` writes the reference's log lines and the
  ``.metrics.jsonl`` records, and LightGCN's Recall rises over a few
  epochs of its own draws on clustered data.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu.ops.sampling import sample_negatives as jax_sample_negatives
from neurec_tpu.trainer import Trainer as JaxTrainer
from neurec_tpu_torch.bridge import params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset, random_dataset
from neurec_tpu_torch.logging import Logger
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import graph
from neurec_tpu_torch.trainer import Trainer

torch.set_float32_matmul_precision("highest")

EVAL = {"topk": [10], "metric": ["Recall", "NDCG"], "test_batch_size": 64}
MF_PAIR = dict(EVAL, recommender="MF", embedding_size=8, reg_mf=0.01, learning_rate=0.05,
               batch_size=128, learner="adam", is_pairwise=True, loss_function="bpr")
MF_POINT = dict(MF_PAIR, is_pairwise=False, loss_function="cross_entropy", num_negatives=2)
LIGHTGCN = dict(EVAL, recommender="LightGCN", embed_size=8, n_layers=2, reg=0.01, lr=0.05,
                batch_size=128, learner="adam", adj_type="gcmc")


class SilentLogger:
    def info(self, msg):
        pass

    debug = warning = error = critical = info


def _both(conf, num_users=64, num_items=128, seed=0):
    ds_j = jax_random_dataset(num_users=num_users, num_items=num_items, seed=seed)
    ds = random_dataset(num_users=num_users, num_items=num_items, seed=seed)
    model_j = jax_get_model(conf["recommender"])(ds_j, JaxDictConfig(conf))
    model = get_model(conf["recommender"])(ds, DictConfig(conf), device="cpu")
    return ds_j, ds, model_j, model


def _numpy_params(model, seed):
    rng = np.random.RandomState(seed)
    d = getattr(model, "emb_dim", None) or model.embedding_size
    return {
        "user_emb": rng.uniform(-0.3, 0.3, (model.num_users, d)).astype(np.float32),
        "item_emb": rng.uniform(-0.3, 0.3, (model.num_items, d)).astype(np.float32),
    }


def _batch(model, seed, B=96):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, model.num_users, B).astype(np.int32)
    w = (rng.rand(B) < 0.75).astype(np.float32)
    if model.data_kind == "pairwise":
        batch = {"users": users, "pos_items": rng.randint(0, model.num_items, B).astype(np.int32),
                 "neg_items": rng.randint(0, model.num_items, B).astype(np.int32)}
    else:
        batch = {"users": users, "items": rng.randint(0, model.num_items, B).astype(np.int32),
                 "labels": (rng.rand(B) < 0.3).astype(np.float32)}
    return batch, w


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("conf,size", [
    (MF_PAIR, (64, 128)),
    (dict(MF_PAIR, loss_function="hinge"), (64, 128)),
    (MF_POINT, (64, 128)),
    (dict(MF_POINT, loss_function="square"), (64, 128)),
    (LIGHTGCN, (64, 128)),
    (dict(LIGHTGCN, n_layers=3), (6000, 3000)),  # above DENSE_LIMIT: the plan branch
], ids=["mf-bpr", "mf-hinge", "mf-ce", "mf-square", "lightgcn-dense", "lightgcn-plan"])
def test_loss_and_gradients_match_jax(conf, size):
    _, _, model_j, model = _both(conf, *size, seed=1)
    if size[0] == 6000:
        assert model.adj.dense is None and model.adj.plan_t is not None
    params_np = _numpy_params(model, 2)
    batch, w = _batch(model, 3)
    want_loss, want_grads = jax.value_and_grad(model_j.loss)(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w))
    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(params_np, "cpu").items()}
    loss = model.loss(params, _to_torch(batch), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(want_grads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_epoch_draws(jt, epoch):
    """The JAX sampled epoch's draws, rebuilt outside its jitted scan
    (neurec_tpu/trainer.py:399-404 and :345-347)."""
    model = jt.model
    B = model.batch_size
    users_flat = jnp.asarray(jt._users_flat)
    N = int(users_flat.shape[0])
    pairwise = model.data_kind == "pairwise"
    n_inst = N if pairwise else N * (1 + model.num_negatives)
    steps = -(-n_inst // B)
    ekey = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1), epoch)
    kp, kn = jax.random.split(ekey)
    perm = jax.random.permutation(kp, steps * B)
    inst = jnp.where(perm < n_inst, perm, 0).astype(jnp.int32).reshape(steps, B)
    w = (perm < n_inst).astype(jnp.float32).reshape(steps, B)
    step_keys = jax.random.split(kn, steps)
    negs = []
    for s in range(steps):
        k_neg, _ = jax.random.split(step_keys[s])
        base = inst[s] if pairwise else inst[s] % N
        rows = jt._padded_items[users_flat[base]]
        negs.append(jax_sample_negatives(k_neg, rows, model.num_items, ()))
    return ekey, np.array(inst), np.array(w), np.array(jnp.stack(negs))


@pytest.mark.parametrize("conf", [MF_PAIR, MF_POINT, LIGHTGCN], ids=["mf-pairwise", "mf-pointwise", "lightgcn"])
def test_epoch_with_injected_jax_draws_matches_jax(conf):
    ds_j, ds, model_j, model = _both(conf, seed=4)
    jt = JaxTrainer(model_j, ds_j, JaxDictConfig(conf), logger=SilentLogger(), seed=7)
    jt.initialize()
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), seed=7, device="cpu")
    np.testing.assert_array_equal(trainer._users_flat.numpy(), jt._users_flat)
    np.testing.assert_array_equal(trainer._pos_flat.numpy(), jt._pos_flat)
    np.testing.assert_array_equal(trainer._padded_items.numpy(), np.asarray(jt._padded_items))

    params_np = _numpy_params(model, 5)
    ekey, inst, w, negs = _jax_epoch_draws(jt, epoch=3)
    assert inst.shape == (trainer.steps, model.batch_size) and (w == 0).any()
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params_j, _, loss_j = jt._epoch_fn(params_j, jt.tx.init(params_j), ekey, jnp.int32(3))

    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(params_np, "cpu").items()}
    params, _, loss = trainer.run_epoch(
        params, trainer.tx(params.values()),
        torch.from_numpy(inst), torch.from_numpy(w), torch.from_numpy(negs))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    got = params_to_numpy(params)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(params_j[k]), atol=2e-5, err_msg=k)
        assert not np.allclose(got[k], params_np[k])  # the epoch moved them


@pytest.mark.parametrize("conf", [MF_PAIR, MF_POINT], ids=["pairwise", "pointwise"])
def test_draw_epoch_follows_the_epoch_contract(conf):
    _, ds, _, model = _both(conf, seed=6)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    inst, w, negs, seeds = trainer.draw_epoch(trainer.epoch_generator(1))
    B, N = model.batch_size, trainer.n_positives
    n_inst = trainer.n_instances
    assert n_inst == (N if conf["is_pairwise"] else 3 * N)
    assert inst.shape == w.shape == negs.shape == (-(-n_inst // B), B)
    real = inst[w == 1]
    assert sorted(real.tolist()) == list(range(n_inst))  # each instance once
    assert (inst[w == 0] == 0).all() and int((w == 0).sum()) == inst.numel() - n_inst
    users = trainer._users_flat[trainer._base(inst)]
    train = ds.train_matrix.tocsr()
    for u, n in zip(users.reshape(-1).tolist(), negs.reshape(-1).tolist()):
        assert 0 <= n < model.num_items and train[u, n] == 0
    again = trainer.draw_epoch(trainer.epoch_generator(1))
    other = trainer.draw_epoch(trainer.epoch_generator(2))
    assert all(torch.equal(a, b) for a, b in zip((inst, w, negs, seeds), again))
    assert not torch.equal(inst, other[0])
    assert seeds.shape == (inst.shape[0],) and seeds.device.type == "cpu"
    assert len(set(seeds.tolist())) == len(seeds)  # one seed per step


def test_train_writes_the_reference_log_lines(tmp_path):
    conf = dict(MF_PAIR, epochs=2, verbose=1)
    _, ds, _, model = _both(conf, seed=8)
    logger = Logger(str(tmp_path / "run.log"))
    trainer = Trainer(model, ds, DictConfig(conf), logger=logger, device="cpu")
    result = trainer.train()
    text = (tmp_path / "run.log").read_text()
    iters = re.findall(r"^\[iter (\d+) : loss : ([\d.]+), time: ([\d.]+)\]$", text, re.M)
    epochs = re.findall(r"^epoch (\d+):\t(.+)$", text, re.M)
    assert [i[0] for i in iters] == ["1", "2"] and [e[0] for e in epochs] == ["1", "2"]
    assert text.splitlines()[0] == trainer.evaluator.metrics_info()
    assert epochs[-1][1] == result and len(result.split("\t")) == 2
    records = [json.loads(line) for line in (tmp_path / "run.log.metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["time_s"] >= 0 for r in records)
    assert records[1]["metrics"]["values"] == result.split("\t")


def _clustered(num_users=60, num_items=80, seed=0):
    """Users and items in 4 groups, most interactions inside the group
    (tests/helpers.py's layout), split 80/20 per user."""
    rng = np.random.RandomState(seed)
    tr, te = [], []
    for u in range(num_users):
        own = [i for i in range(num_items) if i % 4 == u % 4]
        others = [i for i in range(num_items) if i % 4 != u % 4]
        n = rng.randint(8, 25)
        k = min(int(n * 0.8), len(own))
        items = rng.choice(own, k, replace=False).tolist() + rng.choice(others, n - k, replace=False).tolist()
        rng.shuffle(items)
        cut = int(len(items) * 0.8)
        tr += [(u, i) for i in items[:cut]]
        te += [(u, i) for i in items[cut:]]

    def csr(pairs):
        u, i = zip(*pairs)
        return sp.csr_matrix((np.ones(len(u), np.float32), (u, i)), shape=(num_users, num_items))

    return InMemoryDataset(csr(tr), csr(te))


def test_lightgcn_learns():
    conf = DictConfig(dict(EVAL, recommender="LightGCN", embed_size=16, n_layers=3, reg=1e-4, lr=0.05,
                           batch_size=256, epochs=15, verbose=15, learner="adam", adj_type="pre"))
    ds = _clustered()
    model = get_model("LightGCN")(ds, conf, device="cpu")
    trainer = Trainer(model, ds, conf, logger=SilentLogger(), device="cpu")
    trainer.initialize()
    before = trainer.evaluator.evaluator.evaluate_raw(model.predict, trainer.params)
    trainer.train()
    after = trainer.evaluator.evaluator.evaluate_raw(model.predict, trainer.params)
    assert after[0, 0] > before[0, 0] + 0.1, (before, after)  # Recall@10
    assert after[1, 0] > 0.15, after  # NDCG@10, the JAX package's bar


def test_outside_the_slice_raises_not_implemented(tmp_path):
    ds = random_dataset(num_users=30, num_items=40, seed=9)
    model = get_model("MF")(ds, DictConfig(MF_PAIR), device="cpu")
    # no longer a raise: trace_dir writes a torch.profiler trace of the run
    trace_conf = DictConfig(dict(MF_PAIR, epochs=1, verbose=1, trace_dir=str(tmp_path / "t")))
    Trainer(model, ds, trace_conf, logger=SilentLogger(), device="cpu").train()
    (trace,) = (tmp_path / "t").glob("*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]
    # a row long enough to put the padded exclusion table above 64 MB
    wide = sp.csr_matrix(np.ones((1, 80), np.float32))
    big = InMemoryDataset(sp.vstack([wide] + [sp.csr_matrix((1, 80), dtype=np.float32)] * 209_999).tocsr(),
                          sp.csr_matrix((210_000, 80), dtype=np.float32))
    model = get_model("MF")(big, DictConfig(MF_PAIR), device="cpu")
    # no longer a raise: the sampler excludes through the pair Bloom filter;
    # the one user holds all 80 items, which takes the rounds to their cap
    trainer = Trainer(model, big, DictConfig(MF_PAIR), logger=SilentLogger(), device="cpu")
    assert trainer._excl_bloom is not None and not hasattr(trainer, "_padded_items")
    assert trainer._bloom_rounds == 16


def test_plan_branch_training_moves_params_through_the_transposed_plan(monkeypatch):
    """A LightGCN step above DENSE_LIMIT runs the plan SpMM 3 times forward
    and 3 times over the transposed plan (the counts of the CUDA path;
    here each call reaches the plain version)."""
    from neurec_tpu_torch.ops import spmm

    conf = dict(LIGHTGCN, n_layers=3, batch_size=512)
    ds = random_dataset(num_users=6000, num_items=3000, seed=10)
    model = get_model("LightGCN")(ds, DictConfig(conf), device="cpu")
    assert isinstance(model.adj, graph.SparseAdj) and model.adj.plan_t.transposed
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    trainer.initialize()
    seen = []
    real = spmm.plan_spmm

    def spy(plan, x):
        seen.append(plan.transposed)
        return real(plan, x)

    monkeypatch.setattr(spmm, "plan_spmm", spy)
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    inst, w, negs, _ = trainer.draw_epoch(trainer.epoch_generator(1))
    _, _, loss = trainer.run_epoch(trainer.params, trainer.opt_state, inst[:2], w[:2], negs[:2])
    assert seen == [False] * 3 + [True] * 3 + [False] * 3 + [True] * 3
    assert np.isfinite(float(loss))
    for k in before:
        assert not torch.equal(before[k], trainer.params[k])


@pytest.mark.parametrize("conf", [MF_PAIR, LIGHTGCN], ids=["mf", "lightgcn"])
def test_step_seeds_leave_the_epoch_draws_as_they_were(conf):
    """The per-step seeds are drawn after the permutation and the
    negatives, which come out as before; MF and LightGCN ignore the step
    generator, so an epoch with the seeds equals one without."""
    from neurec_tpu_torch.ops.sampling import sample_negatives

    _, ds, _, model = _both(conf, seed=12)
    trainer = Trainer(model, ds, DictConfig(conf), logger=SilentLogger(), device="cpu")
    inst, w, negs, seeds = trainer.draw_epoch(trainer.epoch_generator(5))
    gen = trainer.epoch_generator(5)  # the draws without the seeds, in their order
    B, steps = model.batch_size, trainer.steps
    perm = torch.randperm(steps * B, generator=gen)
    assert torch.equal(inst, torch.where(perm < trainer.n_instances, perm, 0).to(torch.int32).reshape(steps, B))
    assert torch.equal(w, (perm < trainer.n_instances).to(torch.float32).reshape(steps, B))
    users = trainer._users_flat[trainer._base(inst)]
    want = torch.stack([sample_negatives(gen, trainer._padded_items[users[s]], model.num_items, ())
                        for s in range(steps)])
    assert torch.equal(negs, want)

    def epoch(with_seeds):
        params = {k: v.requires_grad_(True) for k, v in params_from_numpy(_numpy_params(model, 13), "cpu").items()}
        _, _, loss = trainer.run_epoch(params, trainer.tx(params.values()), inst, w, negs,
                                       seeds if with_seeds else None)
        return float(loss), params

    (loss_a, pa), (loss_b, pb) = epoch(True), epoch(False)
    assert loss_a == loss_b and all(torch.equal(pa[k], pb[k]) for k in pa)
