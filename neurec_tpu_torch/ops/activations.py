"""Activation registry (port of ``neurec_tpu/ops/activations.py``,
util/tool.py:10-34): the named activations the configs resolve by string,
case-insensitive, plus ``softplus``."""

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


def activation_function(name: str):
    """Resolve an activation by name (case-insensitive)."""
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise NotImplementedError(
            "unknown activation %r (have: %s)" % (name, ", ".join(sorted(_ACTIVATIONS)))
        ) from None
