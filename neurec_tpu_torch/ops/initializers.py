"""Parameter initializer registry.

Port of ``neurec_tpu/ops/initializers.py`` (util/tool.py:79-97,
``get_initializer``): schemes tnormal (truncated normal), uniform, normal,
xavier_normal, xavier_uniform, he_normal, he_uniform, zeros, ones.

An init is ``init(generator, shape) -> float32 tensor`` on the generator's
device. The draws are torch's, not JAX's: a seed gives the same
distribution in both packages, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Init = Callable[[torch.Generator, Sequence[int]], torch.Tensor]

# std of a standard normal truncated to [-2, 2] (jax variance_scaling's
# truncated-normal correction)
_TRUNC_STD = 0.87962566103423978


def _uniform(generator, shape, limit: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def _truncated_normal(generator, shape, std: float) -> torch.Tensor:
    """std * (standard normal truncated to [-2, 2])."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator) * std


def _fans(shape) -> tuple:
    """fan_in, fan_out as ``jax.nn.initializers`` computes them (in axis -2,
    out axis -1, the rest a receptive field)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)) —
    ``jax.nn.initializers.glorot_uniform`` on >= 2-D shapes."""
    fan_in, fan_out = _fans(shape)
    return _uniform(generator, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def get_initializer(init_method: str, stddev: float = 0.01) -> Init:
    """Return ``init(generator, shape) -> tensor`` for the named scheme."""
    m = init_method.lower()
    if m == "tnormal":
        def init(generator, shape):
            return _truncated_normal(generator, shape, stddev)
    elif m == "uniform":
        def init(generator, shape):
            return _uniform(generator, shape, stddev)
    elif m == "normal":
        def init(generator, shape):
            return stddev * torch.randn(
                tuple(shape), generator=generator, device=generator.device, dtype=torch.float32
            )
    elif m in ("xavier_normal", "xavier_uniform", "he_normal", "he_uniform"):
        scale = 2.0 if m.startswith("he") else 1.0

        def init(generator, shape):
            if len(shape) < 2:
                # TF initializes 1-D biases with fan_in = fan_out = shape[-1]
                n = shape[0] if len(shape) else 1
                var = scale / max(float(n), 1.0)
            else:
                fan_in, fan_out = _fans(shape)
                # he: fan_in; xavier: fan_avg
                var = scale / (fan_in if m.startswith("he") else (fan_in + fan_out) / 2.0)
            if m.endswith("uniform"):
                return _uniform(generator, shape, math.sqrt(3.0 * var))
            return _truncated_normal(generator, shape, math.sqrt(var) / _TRUNC_STD)
    elif m == "zeros":
        def init(generator, shape):
            return torch.zeros(tuple(shape), dtype=torch.float32, device=generator.device)
    elif m == "ones":
        def init(generator, shape):
            return torch.ones(tuple(shape), dtype=torch.float32, device=generator.device)
    else:
        raise ValueError("unknown init method '%s'" % init_method)
    return init
