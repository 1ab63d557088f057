"""HSTU in plain PyTorch (Zhai et al., ICML 2024, arXiv:2402.17152; the
generative-recommenders code's HSTU encoder as the configuration states
it), written out whole: the N x N scores materialised, no kernel, no cache.

Inputs: a right-padded history (B, N) of item ids (pad ``num_items``, a
zero row), its lengths n, and times (B, N + 1): position j's action's time,
and at slot n the time of the action the last position predicts. Then::

    x = E[s] sqrt(d) + P
    each layer: z = LN(x); u, v, q, k = split(SiLU(z W1 + b1))
      A[i, j] = SiLU(q_i . k_j + w_p[N-1+j-i] + w_t[bucket(ts[i+1] - ts[j])]) / N
                for j <= i < n (per head), else 0
      x = x + (u * LN(A v)) W2 + b2
    user = L2-normalised x at n - 1; item = L2-normalised E

LN: no affine, eps 1e-6; bucket(x) = clamp(floor(ln(max(|x|, 1)) / 0.301),
0, 128), in float64. Training: the sampled softmax of each real position's
next item against drawn negatives (a negative equal to the target left
out), cosine logits over the temperature, cross-entropy averaged over the
real positions.

Products go through an ``Arith`` (``float64``, ``float32``, or the TF32
control). ``fault`` plants one of the calibration's faults: ``time_bias``
(the time term left out), ``gate_ln`` (the gate's LayerNorm left out),
``half_layers`` (the first half of the layers alone).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.common import Arith

# float32 products in float32 (the configuration states TF32 off)
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

N_BUCKETS = 128
EPS = 1e-6
FAULTS = ("time_bias", "gate_ln", "half_layers")


def _widths(hyper: dict):
    h = int(hyper["num_heads"])
    return int(hyper["item_embedding_dim"]), h, int(hyper["dqk"]), int(hyper["dv"]), int(hyper["max_sequence_length"])


def make_weights(hyper: dict, num_users: int, num_items: int, generator: torch.Generator) -> dict:
    """The published initialisers' scales from one normal draw on the
    generator's device: the item table 0.02, positions sqrt(1/d), W1 0.02,
    W2 glorot (sqrt(2 / (fan_in + fan_out))), the bias tables 0.02; b1 and
    b2 drawn at 0.02 too, so that every leaf is exercised."""
    d, h, dqk, dv, N = _widths(hyper)
    width = 2 * h * (dqk + dv)
    shapes = [(None, "item_emb", (num_items, d), 0.02), (None, "pos_emb", (N, d), math.sqrt(1.0 / d))]
    for layer in range(int(hyper["num_blocks"])):
        shapes += [(layer, "w1", (d, width), 0.02), (layer, "b1", (width,), 0.02),
                   (layer, "w2", (h * dv, d), math.sqrt(2.0 / (h * dv + d))), (layer, "b2", (d,), 0.02),
                   (layer, "w_p", (2 * N - 1,), 0.02), (layer, "w_t", (N_BUCKETS + 1,), 0.02)]
    z = torch.randn((sum(math.prod(s) for _, _, s, _ in shapes),), generator=generator, device=generator.device)
    out, at = {"blocks": [{} for _ in range(int(hyper["num_blocks"]))]}, 0
    for layer, name, shape, std in shapes:
        n = math.prod(shape)
        leaf = (z[at:at + n].view(shape) * std).contiguous()
        at += n
        if layer is None:
            out[name] = leaf
        else:
            out["blocks"][layer][name] = leaf
    return out


def bucket(delta: torch.Tensor) -> torch.Tensor:
    x = delta.abs().clamp_min(1).to(torch.float64)
    return torch.floor(torch.log(x) / 0.301).long().clamp(0, N_BUCKETS)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=EPS)


def encode(weights: dict, seq, lengths, ts, hyper: dict, arith: Arith, fault=None) -> torch.Tensor:
    """(B, N, d) outputs of every position (the pad positions' rows are of
    no use)."""
    d, h, dqk, dv, N = _widths(hyper)
    B = seq.shape[0]
    table = torch.cat([weights["item_emb"], torch.zeros_like(weights["item_emb"][:1])]).to(arith.dtype)
    x = table[seq] * math.sqrt(d) + weights["pos_emb"].to(arith.dtype)[None]
    pos = torch.arange(N, device=seq.device)
    mask = (pos[None, :] <= pos[:, None])[None] & (pos[None, :, None] < lengths[:, None, None])  # (B, i, j)
    rel = N - 1 + pos[None, :] - pos[:, None]
    tb = bucket(ts[:, 1:, None] - ts[:, None, :N])
    blocks = weights["blocks"]
    if fault == "half_layers":
        blocks = blocks[:len(blocks) // 2]
    for blk in blocks:
        uvqk = silu(arith.mm(layer_norm(x), blk["w1"]) + blk["b1"].to(arith.dtype))
        u = uvqk[..., :h * dv]
        v = uvqk[..., h * dv:2 * h * dv].reshape(B, N, h, dv).transpose(1, 2)
        q = uvqk[..., 2 * h * dv:2 * h * dv + h * dqk].reshape(B, N, h, dqk).transpose(1, 2)
        k = uvqk[..., 2 * h * dv + h * dqk:].reshape(B, N, h, dqk).transpose(1, 2)
        rab = blk["w_p"].to(arith.dtype)[rel][None]
        if fault != "time_bias":
            rab = rab + blk["w_t"].to(arith.dtype)[tb]
        s = arith.mm(q, k.transpose(-1, -2)) + rab[:, None]
        a = torch.where(mask[:, None], silu(s) / N, torch.zeros_like(s))
        av = arith.mm(a, v).transpose(1, 2).reshape(B, N, h * dv)
        y = u * (av if fault == "gate_ln" else layer_norm(av))
        x = x + arith.mm(y, blk["w2"]) + blk["b2"].to(arith.dtype)
    return x


def user_vectors(weights: dict, seq, lengths, ts, hyper: dict, arith: Arith, fault=None) -> torch.Tensor:
    x = encode(weights, seq, lengths, ts, hyper, arith, fault)
    last = (lengths - 1).clamp_min(0)
    return l2_normalize(x[torch.arange(x.shape[0], device=x.device), last])


def item_vectors(weights: dict, arith: Arith) -> torch.Tensor:
    return l2_normalize(weights["item_emb"].to(arith.dtype))


def loss(weights: dict, seq, targets, lengths, ts, negatives, hyper: dict, arith: Arith) -> torch.Tensor:
    """The sampled softmax over a batch: ``targets`` (B, N) each position's
    next item, ``negatives`` (B, N, K) its drawn items."""
    hn = l2_normalize(encode(weights, seq, lengths, ts, hyper, arith))
    table = weights["item_emb"].to(arith.dtype)
    pos = l2_normalize(torch.cat([table, torch.zeros_like(table[:1])])[targets])
    neg = l2_normalize(table[negatives])
    logits_pos = torch.sum(arith.op(hn) * arith.op(pos), dim=-1, keepdim=True)
    logits_neg = torch.sum(arith.op(hn)[:, :, None, :] * arith.op(neg), dim=-1)
    logits_neg = torch.where(negatives == targets[..., None], torch.full_like(logits_neg, -math.inf), logits_neg)
    logits = torch.cat([logits_pos, logits_neg], dim=-1) / float(hyper["temperature"])
    ce = -(logits[..., 0] - torch.logsumexp(logits, dim=-1))
    N = seq.shape[1]
    real = (torch.arange(N, device=seq.device)[None, :] < lengths[:, None]).to(ce.dtype)
    return torch.sum(ce * real) / torch.clamp(torch.sum(real), min=1.0)


def width(hyper: dict) -> int:
    return int(hyper["item_embedding_dim"])
