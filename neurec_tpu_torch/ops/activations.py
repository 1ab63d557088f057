"""Activation registry (port of ``neurec_tpu/ops/activations.py``,
util/tool.py:10-34): the named activations the configs resolve by string,
case-insensitive, plus ``softplus``; and the row L2 normalisation of the
autoencoders' inputs and NGCF's layers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "elu": F.elu,
    "identity": lambda x: x,
    "linear": lambda x: x,
    "softmax": lambda x: torch.softmax(x, dim=-1),  # jax.nn.softmax's axis
    "selu": F.selu,
    "softplus": F.softplus,
}


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(max(sum(x^2), eps)) along ``dim``: the clamp is on the
    squared norm, where ``F.normalize`` clamps the norm."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=eps))


def activation_function(name: str):
    """Resolve an activation by name (case-insensitive)."""
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise NotImplementedError(
            "unknown activation %r (have: %s)" % (name, ", ".join(sorted(_ACTIVATIONS)))
        ) from None
