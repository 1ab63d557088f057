"""Transformer primitives of the reference SASRec block (port of
``neurec_tpu/ops/attention.py``; model/sequential_recommender/
SASRec.py:132-266, Kang & McAuley's code):

* pre-LN with the residual adding the NORMALIZED input (a quirk of the
  original implementation, kept);
* causal multi-head attention with key and query padding masks, the
  masked logits set to ``_NEG`` = -2^32 + 1 as the reference does;
* the position-wise FFN as two kernel-size-1 convolutions (dense layers).

Plain torch, batched (B, T, d): one ``torch.matmul`` a product and an
explicit softmax. ``dropout`` is a callable ``x -> x`` (the model's draw
of a mask) or None.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from neurec_tpu_torch.ops.initializers import glorot_uniform

_NEG = -(2.0 ** 32) + 1.0

Dropout = Optional[Callable[[torch.Tensor], torch.Tensor]]


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return params["gamma"] * (x - mean) * torch.rsqrt(var + eps) + params["beta"]


def init_layer_norm(dim: int) -> dict:
    return {"gamma": torch.ones((dim,)), "beta": torch.zeros((dim,))}


def init_dense(generator: torch.Generator, d_in: int, d_out: int) -> dict:
    return {"w": glorot_uniform(generator, (d_in, d_out)), "b": torch.zeros((d_out,), device=generator.device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"]) + params["b"]


def _softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


def multihead_attention(
    params: dict,          # {'q', 'k', 'v': dense params}
    queries: torch.Tensor,  # (B, T, d), normalized by the caller
    keys: torch.Tensor,     # (B, T, d), the raw sequence
    valid: torch.Tensor,    # (B, T) float, 1 at real positions
    num_heads: int,
    causal: bool = True,
    dropout: Dropout = None,
) -> torch.Tensor:
    B, T, d = queries.shape
    dh = d // num_heads
    q = dense(params["q"], queries).reshape(B, T, num_heads, dh).transpose(1, 2)  # (B, h, T, dh)
    k = dense(params["k"], keys).reshape(B, T, num_heads, dh).transpose(1, 2)
    v = dense(params["v"], keys).reshape(B, T, num_heads, dh).transpose(1, 2)

    logits = torch.matmul(q, k.transpose(-1, -2)) / (dh ** 0.5)                   # (B, h, T, T)
    logits = torch.where(valid[:, None, None, :] > 0, logits, torch.full_like(logits, _NEG))
    if causal:
        tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=logits.device))
        logits = torch.where(tri[None, None], logits, torch.full_like(logits, _NEG))
    att = _softmax(logits, dim=-1) * valid[:, None, :, None]  # query masking
    if dropout is not None:
        att = dropout(att)
    out = torch.matmul(att, v).transpose(1, 2).reshape(B, T, d)
    return out + queries  # the residual adds the normalized queries


def feedforward(params: dict, x: torch.Tensor, dropout: Dropout = None) -> torch.Tensor:
    """x (B, T, d), normalized by the caller: relu(x W1) W2 + x, with a
    dropout after each layer."""
    h = torch.relu(dense(params["w1"], x))
    if dropout is not None:
        h = dropout(h)
    h = dense(params["w2"], h)
    if dropout is not None:
        h = dropout(h)
    return h + x
