"""HSTU (``models/sequential/hstu.py``, ``ops/hstu.py``) against its plain
reference (``tests/hstu_reference.py``) on the CPU, at a small size: d 8, 2
blocks, 2 heads of 4, N 16, over ragged histories (1 to 30 train actions,
some past N) with times whose gaps span the buckets.

The reference is fed from the raw sequences here, not from the model's
tables, so a fault in how the model lays out a history shows too. Held:

* the encoder's user vectors, in float64 (the model's params cast) to
  1e-12 (the two differ only in the order of sums), and in float32 to 2e-6
  of the vector's norm: float32 rounding through two layers and their
  LayerNorms stays under ~5e-7, while TF32 products (10 mantissa bits)
  move them by ~1e-3;
* the sampled-softmax loss of one batch and every leaf's gradient, in
  float64, to 1e-10;
* 3 Adam steps through ``Trainer.train_epoch``'s kept steps (the CUDA side
  stubbed: a replay runs the first call's closure) bit-equal to the eager
  steps; the same steps in float64 against the reference's loss and Adam
  (b2 0.98) on the same drawn negatives, to 1e-9 (in float32 a bucket
  entry few pairs touch has Adam magnify the rounding of its small
  gradient, so the comparison is made where rounding is out of the way);
* ``Evaluator.evaluate``'s recorded ids and ``batch_topk``'s against the
  reference's ranking: each rank's item within 1e-6 of the reference's
  best score at that rank (float32 scores against float64);
* the time buckets at their edges and the bucket edges the kernel
  searches; the wrapper's plain path against the reference attention, and
  the pair counts of both launch geometries, whose tiles are read from the
  kernel's source;
* ``by_time``'s order on both of its sorts (a time span under 2**32 and
  over it);
* the layer's path: the fused kernels only for CUDA float32 with no
  gradient wanted and no dropout (``fusable``, on stand-in tensors), the
  plain passes on the CPU and in training, and the counter of fused
  (batch, layer) passes on ``neurec.hstu.encode`` and ``neurec.hstu.attn``
  (the kernels' wrappers stood in for by the plain versions).
"""

import math
import os
import re
import types

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

import tests.hstu_reference as ref
from neurec_tpu_torch import profiling, step_graph
from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
from neurec_tpu_torch.eval import Evaluator
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.models.sequential import hstu as hstu_model
from neurec_tpu_torch.ops import _build, hstu
from neurec_tpu_torch.recommend import batch_topk
from neurec_tpu_torch.step_graph import step_seeds
from neurec_tpu_torch.trainer import Trainer
from tests.test_torch_step_graph import ReplayingGraphs

N, D, H, DH = 16, 8, 2, 4
CONF = dict(recommender="HSTU", item_embedding_dim=D, num_blocks=2, num_heads=H, dqk=DH, dv=DH,
            max_sequence_length=N, num_negatives=5, temperature=0.05, dropout_rate=0.0, batch_size=4, lr=0.01,
            topk=[5], metric=["Recall", "NDCG"], test_batch_size=8)


class SilentLogger:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def histories(num_users=13, num_items=40, seed=5):
    """Each user's actions in time order: (items, times), the last the test
    action; lengths 2 .. 31, gaps from 0 s to years."""
    rng = np.random.RandomState(seed)
    out = []
    for u in range(num_users):
        n = 2 + (u * 7) % 30
        items = rng.choice(num_items, n, replace=False)
        gaps = np.floor(np.exp(rng.uniform(0, 20, n))).astype(np.int64)
        gaps[rng.rand(n) < 0.2] = 0
        out.append((items, 10 ** 9 + np.cumsum(gaps) + np.arange(n)))
    return out


def dataset(hist, num_items=40):
    def csr(rows, data):
        users = np.concatenate([[u] * len(r) for u, r in enumerate(rows)])
        return csr_matrix((np.asarray(data, np.float64), (users, np.concatenate(rows))),
                          shape=(len(rows), num_items))

    tr_items = [it[:-1] for it, _ in hist]
    tr_times = np.concatenate([t[:-1] for _, t in hist])
    te_items = [it[-1:] for it, _ in hist]
    te_times = np.concatenate([t[-1:] for _, t in hist])
    ones = lambda rows: csr(rows, np.ones(sum(map(len, rows))))  # noqa: E731
    return InMemoryDataset(ones(tr_items), ones(te_items), time_matrix=csr(tr_items, tr_times),
                           test_time_matrix=csr(te_items, te_times))


def eval_inputs(hist, users, num_items=40):
    """The reference's inputs from the raw histories: each user's last N
    train actions, right-padded, the test action's time after them."""
    seq = np.full((len(users), N), num_items)
    ts = np.zeros((len(users), N + 1), np.int64)
    lengths = np.zeros(len(users), np.int64)
    for r, u in enumerate(users):
        items, times = hist[u]
        n = min(len(items) - 1, N)
        seq[r, :n], ts[r, :n] = items[-1 - n:-1], times[-1 - n:-1]
        ts[r, n], lengths[r] = times[-1], n
    return torch.from_numpy(seq), torch.from_numpy(lengths), torch.from_numpy(ts)


def train_inputs(hist, users, num_items=40):
    """Each user's training window: its last n + 1 <= N + 1 train actions."""
    seq = np.full((len(users), N), num_items)
    tgt = np.full((len(users), N), num_items)
    ts = np.zeros((len(users), N + 1), np.int64)
    lengths = np.zeros(len(users), np.int64)
    for r, u in enumerate(users):
        items, times = hist[u][0][:-1], hist[u][1][:-1]
        n = min(len(items) - 1, N)
        seq[r, :n], tgt[r, :n] = items[-1 - n:-1], items[-n:]
        ts[r, :n + 1], lengths[r] = times[-1 - n:], n
    return [torch.from_numpy(a) for a in (seq, tgt, lengths, ts)]


@pytest.fixture(scope="module")
def built():
    hist = histories()
    ds = dataset(hist)
    model = get_model("HSTU")(ds, DictConfig(CONF), device="cpu")
    # every leaf exercised: biases and tables drawn too
    g = torch.Generator().manual_seed(11)
    params = map_params(lambda t: (torch.randn(t.shape, generator=g) * 0.5).requires_grad_(),
                        model.init_params(torch.Generator().manual_seed(0)))
    return hist, ds, model, params


def test_time_buckets_at_their_edges():
    got = hstu.time_buckets(torch.tensor([0, 1, -1, 2, -2, 3, 10 ** 8, -(10 ** 8), 2 ** 62]))
    want = [0, 0, 0, 2, 2, 3, 61, 61, 128]
    assert got.tolist() == want
    assert want[3] == math.floor(math.log(2) / 0.301) and want[6] == math.floor(math.log(1e8) / 0.301)
    edges = hstu.bucket_edges("cpu")
    k = torch.arange(1, 129)
    assert bool((hstu.time_buckets(edges) >= k).all()) and bool((hstu.time_buckets(edges - 1) < k).all())
    # the kernel's search: a difference's bucket is the number of edges at or below it
    deltas = torch.cat([torch.arange(0, 5000), torch.randint(0, 2 ** 40, (5000,)), edges, edges - 1])
    counted = (edges[None, :] <= deltas[:, None]).sum(1)
    assert torch.equal(counted, hstu.time_buckets(deltas))


def test_plain_attention_and_pair_counts():
    g = torch.Generator().manual_seed(3)
    B = 5
    q, k, v = (torch.randn((B, N, H, DH), generator=g, dtype=torch.float64) for _ in range(3))
    lengths = torch.tensor([0, 1, 7, 16, 12])
    ts = torch.cumsum(torch.randint(0, 10 ** 6, (B, N + 1), generator=g), 1)
    w_p, w_t = torch.randn(2 * N - 1, generator=g, dtype=torch.float64), torch.randn(129, generator=g,
                                                                                       dtype=torch.float64)
    got = hstu.attention(q, k, v, lengths, ts, w_p, w_t)
    want = ref.attention(q, k, v, lengths, ts, w_p, w_t)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
    assert bool((got[1, 1:] == 0).all()) and bool((got[0] == 0).all())  # pad rows are zero
    n = lengths.numpy()
    real = [H * x * (x + 1) // 2 for x in n]
    plain, needed = hstu.pair_counts(n, N, H, kernel=False)
    assert plain.tolist() == [H * N * N] * B and needed.tolist() == real
    # 32-row tiles: one tile a user here, keys to its last real query in 32s
    kernel, needed = hstu.pair_counts(n, N, H, kernel=True)
    assert kernel.tolist() == [0] + [H * 32 * 32] * 4 and needed.tolist() == real
    assert hstu.pair_counts(np.array([200, 33]), 200, 2, kernel=True)[0].tolist() == [
        2 * 32 * sum(-(-min(q0 + 32, 200) // 32) * 32 for q0 in range(0, 200, 32)), 2 * 32 * (32 + 64)]


def test_the_tile_geometry_is_the_kernels():
    """``pair_counts`` and the wrappers' width checks read the kernels'
    tiles and widest operands from Python copies: they are their sources'."""
    found = {}
    for fname, names in (("hstu_attention.cu", ("BQ", "BK", "DMAX")), ("hstu_layer.cu", ("MAX_D", "MAX_W"))):
        with open(os.path.join(_build.CSRC_DIR, fname)) as fin:
            source = fin.read()
        found.update({name: int(re.search(r"constexpr int %s = (\d+);" % name, source).group(1)) for name in names})
    assert found == {"BQ": hstu.TILE_Q, "BK": hstu.TILE_K, "DMAX": hstu.MAX_HEAD_DIM,
                     "MAX_D": hstu.MAX_LAYER_DIM, "MAX_W": hstu.MAX_LAYER_WIDTH}


@pytest.mark.parametrize("step", [1, 2 ** 33], ids=["seconds_one_key", "wide_span_lexsort"])
def test_by_time_orders_each_user_by_time(step):
    """Both sorts of ``by_time``: times spanning under 2**32 (one packed
    key) and over it (``lexsort``), ties in column order."""
    rng = np.random.RandomState(5)
    users, items = 7, 40
    dense = (rng.rand(users, items) < 0.4) * (1 + rng.randint(0, 6, (users, items))) * step
    dense[dense > 0] += 10 ** 9  # ties (equal times) within a user kept
    tm = csr_matrix(dense.astype(np.float64))
    starts, got_items, got_times = hstu_model.by_time(tm)
    assert starts.tolist() == tm.indptr.tolist()
    assert (int(tm.data.max()) - int(tm.data.min()) >= 2 ** 32) == (step > 1)
    for u in range(users):
        cols, t = tm.indices[tm.indptr[u]:tm.indptr[u + 1]], tm.data[tm.indptr[u]:tm.indptr[u + 1]]
        order = sorted(range(len(cols)), key=lambda i: (t[i], cols[i]))
        assert got_items[starts[u]:starts[u + 1]].tolist() == cols[order].tolist()
        assert got_times[starts[u]:starts[u + 1]].tolist() == t[order].astype(np.int64).tolist()


def test_encoder_matches_the_reference(built):
    hist, _, model, params = built
    users = np.arange(len(hist))
    seq, lengths, ts = eval_inputs(hist, users)
    with torch.no_grad():
        want = ref.user_vectors(params, seq, lengths, ts, H, DH, DH, torch.float64)
        p64 = map_params(lambda t: t.double(), params)
        got64 = model.eval_embeddings(p64, torch.from_numpy(users))[0]
        torch.testing.assert_close(got64, want, rtol=1e-12, atol=1e-12)
        got32 = model.eval_embeddings(params, torch.from_numpy(users))[0]
    assert float((got32.double() - want).norm(dim=1).max()) < 2e-6
    items = ref.item_vectors(params)
    torch.testing.assert_close(model.eval_embeddings(p64, torch.arange(2))[1], items, rtol=1e-12, atol=1e-12)


def test_loss_and_gradients_match_the_reference(built):
    hist, _, model, params = built
    users = model._train_users.numpy()[:4]
    seq, tgt, lengths, ts = train_inputs(hist, users)
    negs = torch.randint(0, 40, (len(users), N, 5), generator=torch.Generator().manual_seed(2))
    negs[0, 0, 0] = tgt[0, 0]  # a negative equal to the target is left out
    p64 = map_params(lambda t: t.detach().double().requires_grad_(), params)
    w = torch.ones(len(users), dtype=torch.float64)
    idx = torch.arange(len(users))
    got = model.seq_loss(p64, model._seq[idx], model._tgt[idx], model._train_len[idx], model._train_ts[idx], w,
                         negs, None)
    assert torch.equal(model._seq[idx], seq) and torch.equal(model._tgt[idx], tgt)
    assert torch.equal(model._train_len[idx].long(), lengths) and torch.equal(model._train_ts[idx], ts)
    r64 = map_params(lambda t: t.detach().double().requires_grad_(), params)
    want = ref.loss(r64, seq, tgt, lengths, ts, negs, H, DH, DH, 0.05)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    got.backward()
    want.backward()
    for (path, a), (_, b) in zip(param_leaves(p64), param_leaves(r64)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-10, atol=1e-12, msg=str(path))


def _trainer(ds, params, kept, monkeypatch):
    model = get_model("HSTU")(ds, DictConfig(CONF), device="cpu")
    t = Trainer(model, ds, DictConfig(CONF), logger=SilentLogger(), seed=3, device="cpu", graphs=kept)
    t.initialize()
    t.params = map_params(lambda p: p.detach().clone().requires_grad_(), params)
    t.opt_state = t.init_opt_state(t.params)
    if kept:
        monkeypatch.setattr(step_graph, "_CudaGraphs", ReplayingGraphs)
        monkeypatch.setattr(step_graph, "captures", lambda device, graphs=True, mesh=None: graphs)
    return t


def test_kept_adam_steps_equal_eager_and_the_reference(built, monkeypatch):
    hist, ds, _, params = built
    eager = _trainer(ds, params, False, monkeypatch)
    eager.train_epoch(1, max_steps=3)
    kept = _trainer(ds, params, True, monkeypatch)
    kept.train_epoch(1, max_steps=3)
    assert kept.kept and all(k.calls == 1 for k in kept.kept.values())
    for (path, a), (_, b) in zip(param_leaves(kept.params), param_leaves(eager.params)):
        assert torch.equal(a, b), path
    # the same steps in float64 against the reference's: the epoch's slots
    # and step seeds, each step's negatives, Adam (b2 0.98; its bias
    # corrections in float32, as optax's)
    p64 = map_params(lambda t: t.detach().double(), params)
    eager64 = _trainer(ds, p64, False, monkeypatch)
    eager64.train_epoch(1, max_steps=3)
    model = eager64.model
    gen = eager64.epoch_generator(1)
    idx, w = model._epoch_slots(gen, int(model._train_users.shape[0]))
    seeds = step_seeds(gen, idx.shape[0])
    users = model._train_users.numpy()
    r = map_params(lambda t: t.detach().clone().requires_grad_(), p64)
    leaves = [t for _, t in param_leaves(r)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    for s in range(3):
        negs = model._negatives_uniform(torch.Generator().manual_seed(int(seeds[s])), (4, N, 5))
        seq, tgt, lengths, ts = train_inputs(hist, users[idx[s].numpy()])
        lengths = lengths * (w[s] > 0)  # pad slots carry weight 0
        loss = ref.loss(r, seq, tgt, lengths, ts, negs, H, DH, DH, 0.05)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        t = np.float32(s + 1)
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** t) for b in (0.9, 0.98))
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(leaves, grads)):
                g = torch.zeros_like(p) if g is None else g
                mu[j] = 0.9 * mu[j] + 0.1 * g
                nu[j] = 0.98 * nu[j] + 0.02 * g * g
                p -= 0.01 * (mu[j] / bc1) / (torch.sqrt(nu[j] / bc2) + 1e-8)
    for (path, a), (_, b) in zip(param_leaves(eager64.params), param_leaves(r)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-9, atol=1e-12, msg=str(path))


def _assert_ranked(ids, hist, users, params, ds, k):
    seq, lengths, ts = eval_inputs(hist, users)
    with torch.no_grad():
        s = ref.user_vectors(params, seq, lengths, ts, H, DH, DH) @ ref.item_vectors(params).T
    train = ds.train_matrix.toarray()[users] > 0
    s = torch.where(torch.from_numpy(train), torch.full_like(s, -math.inf), s)
    best = torch.topk(s, k, dim=1).values
    got = s.gather(1, torch.from_numpy(np.asarray(ids, np.int64)))
    assert float((best - got).max()) < 1e-6


def test_evaluate_and_serve_follow_the_reference_ranking(built):
    hist, ds, model, params = built
    ev = Evaluator.from_dataset(ds, DictConfig(CONF), device="cpu")
    ev.evaluator.record_ids = True
    with profiling.tracing():
        profiling.reset()
        ev.evaluate(model.predict, params)
        spans = [s for s in profiling.spans() if s.name == "neurec.hstu.attn"]
    users = ev.evaluator.test_users
    _assert_ranked(ev.evaluator.last_ids[:len(users)].numpy(), hist, users, params, ds, 5)
    assert len(spans) == 1
    _, lengths, _ = eval_inputs(hist, np.append(users, [0] * (16 - len(users))))  # two batches of 8, pad user 0
    pairs, real = hstu.pair_counts(lengths.numpy(), N, H, False)
    assert spans[0].attrs == {"pairs": 2 * int(pairs.sum()), "real_pairs": 2 * int(real.sum()), "fused_layers": 0}
    users = np.arange(len(hist), dtype=np.int32)
    ids, _ = batch_topk(model, params, 5, users=users, train_matrix=ds.train_matrix, batch_size=8, device="cpu")
    _assert_ranked(ids, hist, users, params, ds, 5)


def _stand_in(device="cuda", dtype=torch.float32, requires_grad=False):
    """What ``fusable`` reads of a tensor, on any device name."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("device,dtype,grad,x_grad,p_grad,dropout,want", [
    ("cuda", torch.float32, False, False, True, False, True),
    ("cuda", torch.float32, True, False, False, False, True),
    ("cuda", torch.float32, True, False, True, False, False),
    ("cuda", torch.float32, True, True, False, False, False),
    ("cuda", torch.float32, False, False, False, True, False),
    ("cpu", torch.float32, False, False, False, False, False),
    ("cuda", torch.float64, False, False, False, False, False),
], ids=["evaluation", "nothing_requires_grad", "params_want_grad", "stream_wants_grad", "dropout", "cpu",
        "float64"])
def test_the_fused_path_is_chosen_where_it_applies(device, dtype, grad, x_grad, p_grad, dropout, want):
    x = _stand_in(device, dtype, x_grad)
    p = {name: _stand_in(requires_grad=p_grad) for name in ("w1", "b1", "w2", "b2", "w_p", "w_t")}
    with torch.set_grad_enabled(grad):
        assert hstu.fusable(x, p, (lambda t: t) if dropout else None) is want


@pytest.mark.parametrize("fused", [False, True], ids=["cpu_plain", "fused_stand_ins"])
def test_the_fused_layers_are_counted(built, monkeypatch, fused):
    """On the CPU every layer takes the plain passes and the counters read
    0; with ``fusable`` answering as on a card and the kernels' wrappers
    stood in for by the plain versions (counting their launches as the
    wrappers do), evaluation counts each (batch, layer) pass from the
    launches over the call and gives the plain path's results, while a
    training loss (gradient wanted) still takes the plain passes."""
    hist, ds, model, params = built
    calls = []
    real = hstu.fusable

    def on_card(x, p, dropout=None):
        return real(_stand_in(dtype=x.dtype, requires_grad=x.requires_grad), p, dropout)

    def wrapped(name, plain):
        def run(*args):
            if not fused:
                raise AssertionError("%s launched on the CPU" % name)
            calls.append(name)
            _build.LAUNCHES["hstu_layer_" + name] += 1  # as the wrapper counts its launch
            return plain(*args)
        return run

    monkeypatch.setattr(hstu, "layer_in", wrapped("in", hstu.layer_in_reference))
    monkeypatch.setattr(hstu, "layer_out", wrapped("out", hstu.layer_out_reference))
    monkeypatch.setattr(hstu, "fusable", on_card if fused else real)
    ev = Evaluator.from_dataset(ds, DictConfig(CONF), device="cpu")
    with profiling.tracing():
        profiling.reset()
        got = ev.evaluate(model.predict, params)
        spans = profiling.spans()
    layers = CONF["num_blocks"] if fused else 0
    assert [s.attrs["fused_layers"] for s in spans if s.name == "neurec.hstu.encode"] == [layers, layers]
    attn = [s for s in spans if s.name == "neurec.hstu.attn"]
    assert len(attn) == 1 and attn[0].attrs["fused_layers"] == 2 * layers  # two batches of 8
    assert calls == ["in", "out"] * 2 * layers
    # the same call by the plain passes gives the same metrics
    monkeypatch.setattr(hstu, "fusable", lambda x, p, dropout=None: False)
    assert ev.evaluate(model.predict, params) == got
    # a training loss wants gradients: the plain passes, none counted
    monkeypatch.setattr(hstu, "fusable", on_card if fused else real)
    del calls[:]
    idx = torch.arange(4)
    negs = torch.randint(0, 40, (4, N, 5), generator=torch.Generator().manual_seed(2))
    with profiling.tracing():
        profiling.reset()
        model.seq_loss(params, model._seq[idx], model._tgt[idx], model._train_len[idx], model._train_ts[idx],
                       torch.ones(4), negs, None)
        encodes = [s.attrs["fused_layers"] for s in profiling.spans() if s.name == "neurec.hstu.encode"]
    assert encodes == [0] and calls == []


@pytest.mark.parametrize("gap,ok", [(1e-7, True), (2.9e-7, True), (3.2e-7, False), (float("nan"), False),
                                    (float("inf"), False)], ids=["near", "within", "past", "nan", "inf"])
def test_the_ab_report_fails_a_kernel_past_its_limit(gap, ok):
    """``benchmarks/hstu_ab.py`` holds each kernel to twice its plain
    version's gap from float64 (1e-7 here: a limit of 3e-7), and a NaN or
    an infinity fails it, in the layer rows and the attention's rows."""
    from neurec_tpu_torch.benchmarks import hstu_ab

    limit = hstu_ab.gap_limit(1e-7)
    report = {"layers": [{"kernel": "hstu_layer_out", "gap": gap, "gap_limit": limit}],
              "shapes": [{"B": 2048, "lengths": "cell", "kernel_gap": gap, "gap_limit": limit}]}
    want = [] if ok else [("hstu_layer_out", gap, limit), ("hstu_attn[2048,cell]", gap, limit)]
    assert repr(hstu_ab.failures(report)) == repr(want)

