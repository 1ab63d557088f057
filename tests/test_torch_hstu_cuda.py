"""HSTU's attention kernel (``csrc/hstu_attention.cu``) and the model on a
card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor neurec_tpu:

    python -m pytest tests/test_torch_hstu_cuda.py -m cuda --noconftest -q

Held:

* the kernel against the plain version in float64 on the card, at the
  evaluation's widths (2048 users, N 200, 2 heads of 25) over ragged
  lengths (0, 1, the tile edges 31, 32, 33, 199, 200 and random) and
  times whose gaps span the buckets, and at other shapes (N 16 and 50, 1
  and 3 heads, heads of 4 and 32): its largest distance from the float64
  result, over each row's largest value, no more than twice the plain
  version's own in float32 (the two sum in other orders; TF32 products
  would read ~1e-3, hundreds of times the plain version's), pad rows
  exactly zero;
* a capture in a CUDA graph replayed on new inputs, and its launches;
* a wrong dtype, a head over 32 and strides the kernel does not take
  raise: the wrapper never falls back;
* the model at the published widths (d 50, 8 blocks, N 200, batch 128):
  the sampled-softmax loss and every leaf's gradient against the
  benchmark's float64 reference on the same negatives (loss to 1e-5, each
  gradient to 1e-4 of its norm: float32 through 8 layers; TF32 reads
  ~1e-2), and two epochs of two training steps through the trainer's kept
  graphs bit-equal to the eager steps.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from neurec_tpu_torch.bridge import map_params, param_leaves
from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.ops import _build, hstu
from neurec_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda

PUBLISHED = dict(recommender="HSTU", item_embedding_dim=50, num_blocks=8, num_heads=2, dqk=25, dv=25,
                 max_sequence_length=200, num_negatives=128, temperature=0.05, dropout_rate=0.2, batch_size=128,
                 lr=0.001, topk=[10], metric=["Recall"], test_batch_size=2048)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def inputs(B, N, h, d, seed, device, dv=None):
    """q, k, v as views of one (B, N, 2 h dv + 2 h d) buffer (the layer's
    fused projection), ragged lengths and times, the two tables."""
    dv = d if dv is None else dv
    g = torch.Generator().manual_seed(seed)
    width = 2 * h * dv + 2 * h * d
    buf = (torch.randn((B, N, width), generator=g) * 0.5).to(device)
    v = buf[..., h * dv:2 * h * dv].unflatten(-1, (h, dv))
    q = buf[..., 2 * h * dv:2 * h * dv + h * d].unflatten(-1, (h, d))
    k = buf[..., 2 * h * dv + h * d:].unflatten(-1, (h, d))
    edges = [0, 1, 31, 32, 33, N - 1, N]
    lengths = torch.randint(0, N + 1, (B,), generator=g)
    lengths[:len(edges)] = torch.tensor([min(e, N) for e in edges])
    gaps = torch.exp(torch.rand((B, N + 1), generator=g) * 20).long()
    gaps[torch.rand((B, N + 1), generator=g) < 0.2] = 0
    ts = (10 ** 9 + torch.cumsum(gaps, 1)).to(device)
    w_p = torch.randn(2 * N - 1, generator=g).to(device)
    w_t = torch.randn(129, generator=g).to(device)
    return q, k, v, lengths.to(device), ts, w_p, w_t


@pytest.mark.parametrize("B,N,h,d,dv", [(2048, 200, 2, 25, 25), (37, 16, 2, 4, 4), (300, 50, 1, 32, 32),
                                       (64, 64, 3, 8, 16)])
def test_the_kernel_matches_the_plain_version(cuda, B, N, h, d, dv):
    q, k, v, lengths, ts, w_p, w_t = inputs(B, N, h, d, 7, cuda, dv)
    got = hstu.attention_kernel(q, k, v, lengths, ts, w_p, w_t)
    plain = hstu.attention_reference(q, k, v, lengths, ts, w_p, w_t)
    want = hstu.attention_reference(*(t.double() for t in (q, k, v)), lengths, ts, w_p.double(), w_t.double())
    torch.cuda.synchronize()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)

    def gap(x):
        return float(((x.double() - want).abs() / scale).max())
    assert gap(got) <= 2 * gap(plain) + 1e-7, (gap(got), gap(plain))
    pad = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    assert bool((got[pad] == 0).all())


def test_captured_in_a_graph_and_replayed(cuda):
    q, k, v, lengths, ts, w_p, w_t = inputs(512, 200, 2, 25, 3, cuda)
    hstu.attention_kernel(q, k, v, lengths, ts, w_p, w_t)  # the first call loads and sets the kernel up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream), _build.captured_launches() as delta:
        with torch.cuda.graph(graph, stream=stream):
            out = hstu.attention_kernel(q, k, v, lengths, ts, w_p, w_t)
    assert delta == {"hstu_attn": 1}
    q2, k2, v2, *_ = inputs(512, 200, 2, 25, 4, cuda)
    for dst, src in ((q, q2), (k, k2), (v, v2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = hstu.attention_kernel(q, k, v, lengths, ts, w_p, w_t)
    assert torch.equal(out, want)


def test_the_wrapper_raises_rather_than_falls_back(cuda):
    q, k, v, lengths, ts, w_p, w_t = inputs(8, 16, 2, 4, 1, cuda)
    with pytest.raises(TypeError):
        hstu.attention_kernel(q.double(), k.double(), v.double(), lengths, ts, w_p, w_t)
    with pytest.raises(ValueError):
        hstu.attention_kernel(q.contiguous(), k, v, lengths, ts, w_p, w_t)  # another row stride
    big = inputs(8, 16, 1, 33, 1, cuda)
    with pytest.raises(ValueError):
        hstu.attention_kernel(*big)
    with pytest.raises(ValueError):
        hstu.attention_kernel(q, k, v, lengths, ts[:, :-1], w_p, w_t)


def published_dataset(users=256, items=3000, seed=0):
    """Histories of 20 .. 400 actions with increasing times, the last to test."""
    rng = np.random.RandomState(seed)
    rows, cols, times, te_rows, te_cols, te_times = [], [], [], [], [], []
    for u in range(users):
        n = rng.randint(20, 401)
        its = rng.choice(items, n, replace=False)
        t = 10 ** 9 + np.cumsum(1 + np.floor(np.exp(rng.uniform(0, 16, n))).astype(np.int64))
        rows += [u] * (n - 1)
        cols += list(its[:-1])
        times += list(t[:-1])
        te_rows.append(u)
        te_cols.append(its[-1])
        te_times.append(t[-1])

    def csr(r, c, d):
        return csr_matrix((np.asarray(d, np.float64), (r, c)), shape=(users, items))

    return InMemoryDataset(csr(rows, cols, np.ones(len(rows))), csr(te_rows, te_cols, np.ones(users)),
                           time_matrix=csr(rows, cols, times), test_time_matrix=csr(te_rows, te_cols, te_times))


def test_loss_and_gradients_at_the_published_widths(cuda):
    from perfbench.reference import hstu as ref
    from perfbench.reference.common import Arith

    ds = published_dataset()
    hyper = dict(PUBLISHED, dropout_rate=0.0)
    model = get_model("HSTU")(ds, DictConfig(hyper), device=cuda)
    w = ref.make_weights(hyper, ds.num_users, ds.num_items, torch.Generator(device=cuda).manual_seed(5))
    params = map_params(lambda t: t.clone().requires_grad_(), w)
    idx = torch.arange(128, device=cuda)
    negs = model._negatives_uniform(torch.Generator(device=cuda).manual_seed(6), (128, 200, 128))
    ones = torch.ones(128, device=cuda)
    batch = (model._seq[idx], model._tgt[idx], model._train_len[idx], model._train_ts[idx])
    loss = model.seq_loss(params, *batch, ones, negs, None)
    loss.backward()
    r = map_params(lambda t: t.double().requires_grad_(), w)
    want = ref.loss(r, batch[0], batch[1], batch[2].long(), batch[3], negs, hyper, Arith("float64"))
    want.backward()
    assert abs(float(loss) - float(want)) < 1e-5 * abs(float(want))
    for (path, a), (_, b) in zip(param_leaves(params), param_leaves(r)):
        gap = float((a.grad.double() - b.grad).norm() / b.grad.norm().clamp_min(1e-30))
        assert gap < 1e-4, (path, gap)


class _Silent:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def test_kept_training_steps_equal_the_eager_ones(cuda):
    ds = published_dataset(users=300)
    conf = DictConfig(PUBLISHED)
    out = []
    for graphs in (False, True):
        model = get_model("HSTU")(ds, conf, device=cuda)
        t = Trainer(model, ds, conf, logger=_Silent(), seed=3, device=cuda, graphs=graphs)
        t.initialize()
        for epoch in (1, 2):
            t.params, t.opt_state, _ = t.train_epoch(epoch, max_steps=2)
        out.append(map_params(lambda p: p.detach().clone(), t.params))
        if graphs:
            assert t.kept and all(k.captured == 0 for k in t.kept.values())  # epoch 2 replayed
    for (path, a), (_, b) in zip(param_leaves(out[0]), param_leaves(out[1])):
        assert torch.equal(a, b), path
