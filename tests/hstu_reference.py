"""HSTU in plain PyTorch, the tests' copy (the benchmark keeps its own,
``perfbench/reference/hstu.py``): Zhai et al., ICML 2024, arXiv:2402.17152,
the generative-recommenders HSTU encoder, written out whole in ``dtype``
(float32 or float64) with the N x N scores materialised. It imports nothing
of the port.

A right-padded history (B, N) of item ids (pad ``num_items``, a zero row),
lengths n, times (B, N + 1) (slot n: the time of the action the last
position predicts)::

    x = E[s] sqrt(d) + P
    each layer: u, v, q, k = split(SiLU(LN(x) W1 + b1))
      A[i, j] = SiLU(q_i . k_j + w_p[N-1+j-i] + w_t[bucket(ts[i+1] - ts[j])]) / N,
                j <= i < n, per head; 0 elsewhere
      x = x + (u * LN(A v)) W2 + b2

LN without affine, eps 1e-6; bucket(x) = clamp(floor(ln(max(|x|, 1)) /
0.301), 0, 128) in float64. ``loss`` is the sampled softmax of each real
position's next item against its negatives (one equal to the target left
out), cosine logits over the temperature, averaged over real positions.
Weights are a dict of the port's layout: ``item_emb``, ``pos_emb``,
``blocks`` [{``w1``, ``b1``, ``w2``, ``b2``, ``w_p``, ``w_t``}].
"""

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6


def bucket(delta):
    return torch.floor(torch.log(delta.abs().clamp_min(1).double()) / 0.301).long().clamp(0, 128)


def layer_norm(x):
    mean = x.mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True) + EPS)


def silu(x):
    return x / (1.0 + torch.exp(-x))


def normalize(x):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=EPS)


def attention(q, k, v, lengths, ts, w_p, w_t):
    """q, k (B, N, h, dqk), v (B, N, h, dv) -> (B, N, h * dv)."""
    B, N, h, dv = v.shape
    pos = torch.arange(N, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None] & (pos[None, :, None] < lengths[:, None, None])
    rab = w_p[N - 1 + pos[None, :] - pos[:, None]][None] + w_t[bucket(ts[:, 1:, None] - ts[:, None, :N])]
    s = q.transpose(1, 2) @ k.permute(0, 2, 3, 1) + rab[:, None]
    a = torch.where(mask[:, None], silu(s) / N, torch.zeros_like(s))
    return (a @ v.transpose(1, 2)).transpose(1, 2).reshape(B, N, h * dv)


def encode(w, seq, lengths, ts, heads, dqk, dv, dtype=torch.float64):
    w = to(w, dtype)
    B, N = seq.shape
    d = w["item_emb"].shape[1]
    table = torch.cat([w["item_emb"], torch.zeros_like(w["item_emb"][:1])])
    x = table[seq] * math.sqrt(d) + w["pos_emb"][None, :N]
    hv, hq = heads * dv, heads * dqk
    for blk in w["blocks"]:
        uvqk = silu(layer_norm(x) @ blk["w1"] + blk["b1"])
        u, v = uvqk[..., :hv], uvqk[..., hv:2 * hv].reshape(B, N, heads, dv)
        q = uvqk[..., 2 * hv:2 * hv + hq].reshape(B, N, heads, dqk)
        k = uvqk[..., 2 * hv + hq:].reshape(B, N, heads, dqk)
        y = u * layer_norm(attention(q, k, v, lengths, ts, blk["w_p"], blk["w_t"]))
        x = x + y @ blk["w2"] + blk["b2"]
    return x


def user_vectors(w, seq, lengths, ts, heads, dqk, dv, dtype=torch.float64):
    x = encode(w, seq, lengths, ts, heads, dqk, dv, dtype)
    return normalize(x[torch.arange(x.shape[0]), (lengths - 1).clamp_min(0)])


def item_vectors(w, dtype=torch.float64):
    return normalize(w["item_emb"].to(dtype))


def loss(w, seq, targets, lengths, ts, negatives, heads, dqk, dv, temperature, dtype=torch.float64):
    hn = normalize(encode(w, seq, lengths, ts, heads, dqk, dv, dtype))
    table = w["item_emb"].to(dtype)
    pos = normalize(torch.cat([table, torch.zeros_like(table[:1])])[targets])
    neg = normalize(table[negatives])
    lp = torch.sum(hn * pos, dim=-1, keepdim=True)
    ln = torch.sum(hn[:, :, None, :] * neg, dim=-1)
    ln = torch.where(negatives == targets[..., None], torch.full_like(ln, -math.inf), ln)
    logits = torch.cat([lp, ln], dim=-1) / temperature
    ce = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    real = (torch.arange(seq.shape[1])[None, :] < lengths[:, None]).to(ce.dtype)
    return torch.sum(ce * real) / torch.clamp(torch.sum(real), min=1.0)


def to(w, dtype):
    """``w``'s leaves in ``dtype``, still leaves of the autograd graph of
    ``w``'s own."""
    if isinstance(w, dict):
        return {k: to(v, dtype) for k, v in w.items()}
    if isinstance(w, list):
        return [to(v, dtype) for v in w]
    return w.to(dtype)
