"""HSTU's attention kernel (``csrc/hstu_attention.cu``), its layer kernels
(``csrc/hstu_layer.cu``) and the model on a card.

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
* each layer kernel against its plain composition (``layer_in_reference``,
  ``layer_out_reference``) at the evaluation's widths (d 50, 2 heads of 25,
  N 200) for 64 and 2048 users and at narrower and ragged widths, over
  ragged lengths 1 .. N with the attention's pad rows zero: its largest
  distance from the float64 plain composition, over each row's largest
  value, no more than twice the plain version's own in float32, and the
  pad rows of ``layer_out`` (x + b2) equal to the plain version's;
* the 8-layer encoder at the published widths on the fused path (no
  gradient) no farther from the float64 reference than twice the float32
  plain path (gradient wanted), and within 1e-5 of the row's norm; 8
  launches of each layer kernel on the fused path, none on the plain;
* the layer kernels captured in a CUDA graph and replayed on new inputs,
  and at the evaluation's shape over four seeds replayed 50 times, each
  replay's bits the eager calls';
* their wrappers raising on a wrong dtype, device, shape, stride, width
  or alignment;
* the model at the published widths (d 50, 8 blocks, N 200, batch 128):
  the sampled-softmax loss and every leaf's gradient against the
  benchmark's float64 reference on the same negatives (loss to 1e-5, each
  gradient to 1e-4 of its norm: float32 through 8 layers; TF32 reads
  ~1e-2), and two epochs of two training steps through the trainer's kept
  graphs bit-equal to the eager steps.
"""

import math

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


LAYER_SHAPES = [(2048, 200, 50, 2, 25, 25), (64, 200, 50, 2, 25, 25), (37, 16, 16, 2, 8, 8), (5, 7, 13, 3, 5, 3),
                (9, 11, 6, 1, 3, 2)]


def layer_inputs(B, N, d, h, dqk, dv, seed, device):
    """x, the weights, a projection (uvqk) and an attention output, zero at
    the pad rows of ragged lengths 1 .. N (1 and N among them); the pad mask."""
    g = torch.Generator().manual_seed(seed)
    W, hv = 2 * h * (dqk + dv), h * dv
    lengths = torch.randint(1, N + 1, (B,), generator=g)
    lengths[:2] = torch.tensor([1, N])[:B]
    pad = torch.arange(N)[None, :] >= lengths[:, None]
    x = torch.randn((B, N, d), generator=g) * 2 + 0.5
    w1 = torch.randn((d, W), generator=g) / math.sqrt(d)
    b1 = torch.randn((W,), generator=g) * 0.5
    uvqk = torch.randn((B, N, W), generator=g)
    attn = torch.where(pad[..., None], torch.zeros(()), torch.randn((B, N, hv), generator=g) * 0.1)
    w2 = torch.randn((hv, d), generator=g) / math.sqrt(hv)
    b2 = torch.randn((d,), generator=g) * 0.5
    return [t.to(device) for t in (x, w1, b1, uvqk, attn, w2, b2, pad)]


def _row_gap(got, want):
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got.double() - want).abs() / scale).max())


@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=["x".join(map(str, s)) for s in LAYER_SHAPES])
@pytest.mark.parametrize("kernel", ["in", "out"])
def test_the_layer_kernels_match_the_plain_composition(cuda, kernel, shape):
    B, N, d, h, dqk, dv = shape
    x, w1, b1, uvqk, attn, w2, b2, pad = layer_inputs(*shape, 7, cuda)
    u = uvqk[..., :h * dv]
    if kernel == "in":
        args = (x, w1, b1)
        fused, plain = hstu.layer_in, hstu.layer_in_reference
    else:
        args = (attn, u, x, w2, b2)
        fused, plain = hstu.layer_out, hstu.layer_out_reference
    got, ref32 = fused(*args), plain(*args)
    want = plain(*(t.double() for t in args))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref32.shape
    assert _row_gap(got, want) <= 2 * _row_gap(ref32, want) + 1e-7, (_row_gap(got, want), _row_gap(ref32, want))
    if kernel == "out":
        assert torch.equal(got[pad], ref32[pad]) and torch.equal(got[pad], (x + b2)[pad])


def test_the_fused_encoder_matches_float64(cuda):
    from perfbench.reference import hstu as ref
    from perfbench.reference.common import Arith

    ds = published_dataset()
    hyper = dict(PUBLISHED, dropout_rate=0.0)
    model = get_model("HSTU")(ds, DictConfig(hyper), device=cuda)
    w = ref.make_weights(hyper, ds.num_users, ds.num_items, torch.Generator(device=cuda).manual_seed(5))
    users = torch.arange(ds.num_users, device=cuda)
    seq, lengths, ts = model._eval_seq[users], model._eval_len[users], model._eval_ts[users]
    _build.reset_launches()
    with torch.no_grad():
        fused = model.encode(w, seq, lengths, ts)
    assert (_build.LAUNCHES["hstu_layer_in"], _build.LAUNCHES["hstu_layer_out"]) == (8, 8)
    with torch.enable_grad():
        plain = model.encode(map_params(lambda t: t.clone().requires_grad_(), w), seq, lengths, ts).detach()
    assert (_build.LAUNCHES["hstu_layer_in"], _build.LAUNCHES["hstu_layer_out"]) == (8, 8)
    with torch.no_grad():
        want = ref.encode(w, seq, lengths.long(), ts, hyper, Arith("float64"))
    real = torch.arange(seq.shape[1], device=cuda)[None, :] < lengths[:, None]

    def gap(got):
        return float(((got.double() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30))[real].max())
    assert gap(fused) <= 2 * gap(plain) and gap(fused) < 1e-5, (gap(fused), gap(plain))


def test_the_layer_kernels_are_captured_and_replayed(cuda):
    x, w1, b1, _, attn, w2, b2, _ = layer_inputs(512, 200, 50, 2, 25, 25, 3, cuda)
    hstu.layer_out(attn, hstu.layer_in(x, w1, b1)[..., :50], x, w2, b2)  # loads and sets the kernels up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream), _build.captured_launches() as delta:
        with torch.cuda.graph(graph, stream=stream):
            uvqk = hstu.layer_in(x, w1, b1)
            out = hstu.layer_out(attn, uvqk[..., :50], x, w2, b2)
    assert delta == {"hstu_layer_in": 1, "hstu_layer_out": 1}
    x2, _, _, _, attn2, *_ = layer_inputs(512, 200, 50, 2, 25, 25, 4, cuda)
    x.copy_(x2)
    attn.copy_(attn2)
    graph.replay()
    torch.cuda.synchronize()
    want = hstu.layer_in(x, w1, b1)
    assert torch.equal(uvqk, want)
    assert torch.equal(out, hstu.layer_out(attn, want[..., :50], x, w2, b2))


@pytest.mark.parametrize("seed", range(4))
def test_the_layer_kernels_repeat_their_bits_at_the_cells_shape(cuda, seed):
    """At the evaluation's (2048, 200, 50), where each block walks many
    tiles and stages the next behind the current one: the kernels within
    their limit of float64, and a graph of both replayed 50 times gives
    the eager calls' bits every time (a race between the staging and the
    reads would show as bits that move, or as a NaN)."""
    x, w1, b1, _, attn, w2, b2, _ = layer_inputs(2048, 200, 50, 2, 25, 25, 100 + seed, cuda)
    uvqk = hstu.layer_in(x, w1, b1)
    out = hstu.layer_out(attn, uvqk[..., :50], x, w2, b2)
    for got, args, plain in ((uvqk, (x, w1, b1), hstu.layer_in_reference),
                             (out, (attn, uvqk[..., :50], x, w2, b2), hstu.layer_out_reference)):
        want = plain(*(t.double() for t in args))
        gap, plain_gap = _row_gap(got, want), _row_gap(plain(*args), want)
        assert math.isfinite(gap) and gap <= 2 * plain_gap + 1e-7, (gap, plain_gap)
        del want
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        g_uvqk = hstu.layer_in(x, w1, b1)
        g_out = hstu.layer_out(attn, g_uvqk[..., :50], x, w2, b2)
    for _ in range(50):
        g_uvqk.zero_()
        g_out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_uvqk, uvqk) and torch.equal(g_out, out)


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


RAISES = {
    "in_dtype": (TypeError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(x.double(), w1.double(), b1.double())),
    "in_device": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(x.cpu(), w1.cpu(), b1.cpu())),
    "in_weight_device": (TypeError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(x, w1.cpu(), b1)),
    "in_strided": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(x[:, ::2], w1, b1)),
    "in_shape": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(x, w1[:-1], b1)),
    "in_wide": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(
        torch.cat([x, x[..., :15]], -1), torch.cat([w1, w1[:15]]), b1)),
    "in_misaligned": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_in(_misaligned(x), w1, b1)),
    "out_dtype": (TypeError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_out(a.double(), u, x, w2, b2)),
    "out_u_stride": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_out(
        a, torch.cat([u, u[:, :1]], 1)[:, :-1], x, w2, b2)),
    "out_u_columns": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_out(
        a, torch.cat([u, u], -1)[..., ::2], x, w2, b2)),
    "out_shape": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_out(a, u, x, w2[:, :-1], b2)),
    "out_misaligned": (ValueError, lambda x, w1, b1, u, a, w2, b2: hstu.layer_out(_misaligned(a), u, x, w2, b2)),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_the_layer_wrappers_raise_rather_than_fall_back(cuda, case):
    x, w1, b1, uvqk, attn, w2, b2, _ = layer_inputs(4, 16, 50, 2, 25, 25, 1, cuda)
    error, call = RAISES[case]
    with pytest.raises(error):
        call(x, w1, b1, uvqk[..., :50], attn, w2, b2)


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
