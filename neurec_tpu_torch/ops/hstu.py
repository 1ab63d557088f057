"""HSTU's layer: pointwise attention under a relative position and time
bias, the gated output path (Zhai et al., "Actions Speak Louder than
Words", ICML 2024, arXiv:2402.17152; the generative-recommenders code's
``SequentialTransductionUnitJagged`` and
``RelativeBucketedTimeAndPositionBasedBias``).

A batch is right-padded: user ``b``'s history fills positions
``0 .. n_b - 1`` of ``N``. Its times ``ts`` are (B, N + 1) int64: ``ts[b,
j]`` the time of position ``j``'s action, ``ts[b, n_b]`` the time of the
action the last position predicts (the target's). Per head, for real
positions ``j <= i``::

    rab[i, j] = w_p[N - 1 + j - i] + w_t[bucket(ts[b, i + 1] - ts[b, j])]
    A[i, j]   = SiLU(q_i . k_j + rab[i, j]) / N

and 0 elsewhere (``N`` the padded length, whatever ``n_b``); the output
row ``i`` is ``sum_j A[i, j] v_j``, zero at pad positions.
``bucket(x) = clamp(floor(ln(max(|x|, 1)) / 0.301), 0, 128)``, evaluated
in float64 on integer times (the published code takes the log in float32;
here a bucket's edges are float64's, the same for the kernel, the plain
version and the references).

``attention`` takes the plain version, ``attention_reference``, on a CPU
tensor, and on a CUDA tensor launches ``csrc/hstu_attention.cu``
(``neurec::hstu_attn_fwd``) or raises. Its backward is the plain version's,
recomputed from the saved q, k and v (``_Attention``). The kernel finds a
time's bucket by counting the bucket edges ``bucket_edges()`` at or below
it: the least |Δ| of each bucket 1..128 and up, found here with
``time_buckets`` itself, so both give the same buckets.

``layer`` is one HSTU layer over a (B, N, d) stream; ``pair_counts`` the
(query, key) pairs a call's launch geometry computes and those the
mathematics needs, which the model records on the span
``neurec.hstu.attn``.

Around the attention, a layer runs ``layer_in_reference`` (``SiLU(LN(x)
W1 + b1)``) and ``layer_out_reference`` (``x + (u * LN(attn)) W2 + b2``),
plain torch, or, where ``fusable`` says so (CUDA float32, no gradient
wanted, no dropout: evaluation), ``layer_in`` and ``layer_out``, which
launch ``csrc/hstu_layer.cu`` (``neurec::hstu_layer_in``,
``neurec::hstu_layer_out``) or raise. Training keeps the plain graph and
its autograd.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neurec_tpu_torch.ops import _build

N_BUCKETS = 128
BUCKET_DIV = 0.301
LN_EPS = 1e-6
# the kernel's query and key tiles (csrc/hstu_attention.cu: BQ, BK)
TILE_Q = TILE_K = 32
# the widest head the kernel takes (csrc/hstu_attention.cu: DMAX)
MAX_HEAD_DIM = 32
# the widest stream and attention output, and fused projection, the layer
# kernels take (csrc/hstu_layer.cu: MAX_D, MAX_W)
MAX_LAYER_DIM, MAX_LAYER_WIDTH = 64, 256


def time_buckets(delta: torch.Tensor) -> torch.Tensor:
    """int64 buckets of int64 time differences."""
    x = delta.abs().clamp_min(1).to(torch.float64)
    return torch.floor(torch.log(x) / BUCKET_DIV).long().clamp(0, N_BUCKETS)


_EDGES: Dict[torch.device, torch.Tensor] = {}


def bucket_edges(device) -> torch.Tensor:
    """(128,) int64: entry ``k - 1`` the least |Δ| whose bucket is ``k`` or
    more, found by bisection over ``time_buckets`` on the CPU; kept per
    device. A difference's bucket is the number of edges at or below it."""
    device = torch.device(device)
    edges = _EDGES.get(device)
    if edges is None:
        want = torch.arange(1, N_BUCKETS + 1, dtype=torch.int64)
        lo, hi = torch.ones_like(want), torch.full_like(want, 2 ** 62)
        while bool((lo < hi).any()):
            mid = (lo + hi) // 2
            up = time_buckets(mid) >= want
            hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid + 1)
        edges = _EDGES[device] = lo.to(device)
    return edges


def relative_bias(ts: torch.Tensor, w_p: torch.Tensor, w_t: torch.Tensor, N: int) -> torch.Tensor:
    """(B, N, N) rab of each (query i, key j): the position term and the
    time term (module docstring); garbage where ``j > i`` (masked later)."""
    pos = torch.arange(N, device=ts.device)
    rel = (N - 1 + pos[None, :] - pos[:, None]).clamp(0, 2 * N - 2)
    delta = ts[:, 1:N + 1, None] - ts[:, None, :N]
    return w_p[rel][None] + w_t[time_buckets(delta)]


def causal_mask(lengths: torch.Tensor, N: int) -> torch.Tensor:
    """(B, N, N) bool: True where ``j <= i < n_b``."""
    pos = torch.arange(N, device=lengths.device)
    return (pos[None, :] <= pos[:, None])[None] & (pos[None, :, None] < lengths[:, None, None])


def attention_reference(q, k, v, lengths, ts, w_p, w_t) -> torch.Tensor:
    """The plain version: q, k (B, N, h, dqk), v (B, N, h, dv), lengths (B,),
    ts (B, N + 1) -> (B, N, h * dv); the N x N scores materialised."""
    B, N, h, dv = v.shape
    s = torch.einsum("bihd,bjhd->bhij", q, k) + relative_bias(ts, w_p, w_t, N)[:, None].to(q.dtype)
    a = torch.where(causal_mask(lengths, N)[:, None], F.silu(s) / N, torch.zeros_like(s))
    return torch.einsum("bhij,bjhd->bihd", a, v).reshape(B, N, h * dv)


class _Attention(torch.autograd.Function):
    """The attention: forward by the kernel on a CUDA tensor (the plain
    version on a CPU one); backward by the plain version's graph, rebuilt
    from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, w_p, w_t, lengths, ts):
        ctx.save_for_backward(q, k, v, w_p, w_t, lengths, ts)
        if q.device.type == "cpu":
            return attention_reference(q, k, v, lengths, ts, w_p, w_t)
        return attention_kernel(q, k, v, lengths, ts, w_p, w_t)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, w_p, w_t, lengths, ts = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in zip((q, k, v, w_p, w_t), ctx.needs_input_grad)]
        with torch.enable_grad():
            out = attention_reference(*inputs[:3], lengths, ts, *inputs[3:])
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None, None)


def attention(q, k, v, lengths, ts, w_p, w_t) -> torch.Tensor:
    """HSTU's attention (module docstring): (B, N, h * dv)."""
    return _Attention.apply(q, k, v, w_p, w_t, lengths, ts)


_ATTN = _build.Entry("hstu_attention", "neurec_hstu_attn_fwd", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
    ctypes.c_void_p] * 6 + [ctypes.c_int] * 5)


@_build.swappable
def attention_kernel(q, k, v, lengths, ts, w_p, w_t) -> torch.Tensor:
    """The attention by ``csrc/hstu_attention.cu``: q, k (B, N, h, dqk) and
    v (B, N, h, dv) float32 views of one buffer's rows (a position's row at
    a stride ``ld``, a head's columns together), lengths (B,) int32, ts (B,
    N + 1) int64, w_p (2N - 1,) and w_t (129,) float32 -> (B, N, h * dv)
    float32. ``LAUNCHES`` counts ``hstu_attn``."""
    B, N, h, dqk = q.shape
    dv = v.shape[3]
    for name, t, d in (("q", q, dqk), ("k", k, dqk), ("v", v, dv)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError("the HSTU attention kernel takes float32 %s on %s" % (name, q.device))
        if tuple(t.shape) != (B, N, h, d) or t.stride(3) != 1 or t.stride(2) != d or \
                t.stride(0) != N * t.stride(1):
            raise ValueError("%s: shape %s strides %s are not rows of (h, %d) at one stride"
                             % (name, tuple(t.shape), t.stride(), d))
    ld = q.stride(1)
    if k.stride(1) != ld or v.stride(1) != ld:
        raise ValueError("q, k and v must share a row stride, got %d, %d, %d" % (ld, k.stride(1), v.stride(1)))
    if max(dqk, dv) > MAX_HEAD_DIM:
        raise ValueError("the HSTU attention kernel takes heads of at most %d, got %d, %d" % (MAX_HEAD_DIM, dqk, dv))
    lengths = lengths.to(torch.int32).contiguous()
    ts = ts.to(torch.int64).contiguous()
    if tuple(ts.shape) != (B, N + 1) or tuple(lengths.shape) != (B,):
        raise ValueError("lengths (B,) and ts (B, N + 1) expected, got %s, %s" % (tuple(lengths.shape),
                                                                                  tuple(ts.shape)))
    w_p, w_t = w_p.float().contiguous(), w_t.float().contiguous()
    if w_p.numel() != 2 * N - 1 or w_t.numel() != N_BUCKETS + 1:
        raise ValueError("w_p (%d,) and w_t (%d,) expected" % (2 * N - 1, N_BUCKETS + 1))
    out = torch.empty((B, N, h * dv), dtype=torch.float32, device=q.device)
    if B:
        if q.device.type != "cuda":
            raise ValueError("the HSTU attention kernel runs on cuda, not %s" % q.device)
        _ATTN(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, lengths.data_ptr(), ts.data_ptr(),
              w_p.data_ptr(), w_t.data_ptr(), bucket_edges(q.device).data_ptr(), out.data_ptr(), B, N, h, dqk, dv,
              counts=("hstu_attn",))
    return out


def pair_counts(lengths: np.ndarray, N: int, heads: int, kernel: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(pairs computed, pairs needed), int64 a row, of an attention call
    over histories of ``lengths`` (host ints, a row each) at padded length
    ``N``, summed over ``heads``. The mathematics needs the causal pairs,
    h n (n + 1) / 2 a row. The kernel computes, for each query tile that
    holds a real position, the tile's rows against the key tiles up to its
    last real query; the plain version the whole N x N."""
    n = np.minimum(np.asarray(lengths, dtype=np.int64), N)
    real = heads * (n * (n + 1) // 2)
    if not kernel:
        return np.full(len(n), heads * N * N, dtype=np.int64), real
    q0 = np.arange(0, N, TILE_Q, dtype=np.int64)[None, :]
    kend = np.minimum(q0 + TILE_Q, n[:, None])
    key_cols = np.where(q0 < n[:, None], -(-kend // TILE_K) * TILE_K, 0)
    return heads * TILE_Q * key_cols.sum(1), real


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with no affine, eps 1e-6. Written as a
    reduction and elementwise passes: ``F.layer_norm``'s kernel for rows of
    50 reads at ~36 GB/s on the H100 (2.5 s of a 3.6 s evaluation call),
    these at the card's bandwidth."""
    var, mean = torch.var_mean(x, dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS)


def layer_in_reference(x, w1, b1) -> torch.Tensor:
    """The plain version of a layer's pass before the attention: (B, N, d)
    -> ``SiLU(LN(x) W1 + b1)``, (B, N, W)."""
    return F.silu(layer_norm(x) @ w1 + b1)


def layer_out_reference(attn, u, x, w2, b2, dropout=None) -> torch.Tensor:
    """The plain version of a layer's pass after the attention: ``x +
    (dropout(u * LN(attn)) W2 + b2)``."""
    y = u * layer_norm(attn)
    if dropout is not None:
        y = dropout(y)
    return x + (y @ w2 + b2)


def fusable(x, p: dict, dropout=None) -> bool:
    """Whether ``layer`` takes the fused kernels: a CUDA float32 stream, no
    dropout, and no gradient wanted (grad mode off, or nothing of ``x`` and
    ``p`` requires one). Training keeps the plain passes and their
    autograd graph."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or dropout is not None:
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in p.values())))


def _on_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError("the HSTU layer kernels run on cuda, not %s" % x.device)


def _layer_operand(name: str, t, device, shape) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise TypeError("the HSTU layer kernels take float32 %s on %s, got %s on %s" % (name, device, t.dtype,
                                                                                        t.device))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))


def _rows(name: str, t, device, shape) -> None:
    """A contiguous, 16-byte aligned float32 operand of ``shape``."""
    _layer_operand(name, t, device, shape)
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("%s: strides %s at offset %d are not contiguous 16-byte aligned rows"
                         % (name, t.stride(), t.data_ptr() % 16))


def _widths(**widths) -> None:
    for name, (n, most) in widths.items():
        if not 1 <= n <= most:
            raise ValueError("the HSTU layer kernels take %s of 1 .. %d, got %d" % (name, most, n))


_LAYER_IN = _build.Entry("hstu_layer", "neurec_hstu_layer_in", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
    ctypes.c_int] * 2)
_LAYER_OUT = _build.Entry("hstu_layer", "neurec_hstu_layer_out", [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [
    ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2)


@_build.swappable
def layer_in(x, w1, b1) -> torch.Tensor:
    """``SiLU(LN(x) W1 + b1)`` by ``csrc/hstu_layer.cu``: x (B, N, d)
    float32, contiguous, w1 (d, W), b1 (W,) -> (B, N, W) float32. ``LAUNCHES``
    counts ``hstu_layer_in``."""
    _on_cuda(x)
    B, N, d = x.shape
    W = w1.shape[-1]
    _widths(d=(d, MAX_LAYER_DIM), W=(W, MAX_LAYER_WIDTH))
    _rows("x", x, x.device, (B, N, d))
    _layer_operand("w1", w1, x.device, (d, W))
    _layer_operand("b1", b1, x.device, (W,))
    w1, b1 = w1.contiguous(), b1.contiguous()
    out = torch.empty((B, N, W), dtype=torch.float32, device=x.device)
    if out.numel():
        _LAYER_IN(x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), B * N, d, W,
                  counts=("hstu_layer_in",))
    return out


@_build.swappable
def layer_out(attn, u, x, w2, b2) -> torch.Tensor:
    """``x + ((u * LN(attn)) W2 + b2)`` by ``csrc/hstu_layer.cu``: attn (B,
    N, hv) and x (B, N, d) float32, contiguous; u (B, N, hv) rows at one
    stride, its columns together (the first hv columns of the layer's
    projection); w2 (hv, d), b2 (d,) -> the new x, (B, N, d) float32.
    ``LAUNCHES`` counts ``hstu_layer_out``."""
    _on_cuda(x)
    B, N, hv = attn.shape
    d = x.shape[-1]
    _widths(hv=(hv, MAX_LAYER_DIM), d=(d, MAX_LAYER_DIM))
    _rows("attn", attn, x.device, (B, N, hv))
    _rows("x", x, x.device, (B, N, d))
    _layer_operand("u", u, x.device, (B, N, hv))
    if u.stride(2) != 1 or u.stride(0) != N * u.stride(1) or u.stride(1) < hv:
        raise ValueError("u: strides %s are not rows of %d at one stride" % (u.stride(), hv))
    _layer_operand("w2", w2, x.device, (hv, d))
    _layer_operand("b2", b2, x.device, (d,))
    w2, b2 = w2.contiguous(), b2.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        _LAYER_OUT(x.device, attn.data_ptr(), u.data_ptr(), u.stride(1), x.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), out.data_ptr(), B * N, hv, d, counts=("hstu_layer_out",))
    return out


def layer(p: dict, x, lengths, ts, heads: int, dqk: int, dv: int, dropout=None) -> torch.Tensor:
    """One HSTU layer: ``x + (dropout(u * LN(A v)) W2 + b2)`` with u, v, q,
    k from ``SiLU(LN(x) W1 + b1)``; ``p`` holds ``w1``, ``b1``, ``w2``,
    ``b2``, ``w_p``, ``w_t``. The passes around the attention are the two
    fused kernels where ``fusable``, else the plain versions."""
    fused = fusable(x, p, dropout)
    uvqk = (layer_in if fused else layer_in_reference)(x, p["w1"], p["b1"])
    hv, hq = heads * dv, heads * dqk
    u = uvqk[..., :hv]
    v = uvqk[..., hv:2 * hv].unflatten(-1, (heads, dv))
    q = uvqk[..., 2 * hv:2 * hv + hq].unflatten(-1, (heads, dqk))
    k = uvqk[..., 2 * hv + hq:].unflatten(-1, (heads, dqk))
    a = attention(q, k, v, lengths, ts, p["w_p"], p["w_t"])
    if fused:
        return layer_out(a, u, x, p["w2"], p["b2"])
    return layer_out_reference(a, u, x, p["w2"], p["b2"], dropout)
