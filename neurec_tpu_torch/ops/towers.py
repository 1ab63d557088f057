"""Dense MLP towers (port of ``neurec_tpu/ops/towers.py``): a stack is a
list of ``{"w": (d_in, d_out), "b": (d_out,)}`` layers, kernels drawn
glorot_uniform and biases zero (TF's dense-layer defaults, NeuMF.py:81-82,
MLP.py:54-66)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from neurec_tpu_torch.ops.initializers import glorot_uniform


def init_dense_stack(generator: torch.Generator, in_dim: int, units: Sequence[int]) -> List[dict]:
    """``[{"w": (d_in, d_out), "b": (d_out,)}]`` on the generator's device."""
    params, d = [], in_dim
    for n in units:
        params.append({"w": glorot_uniform(generator, (d, n)),
                       "b": torch.zeros((n,), dtype=torch.float32, device=generator.device)})
        d = n
    return params


def apply_dense_stack(
    params: List[dict],
    x: torch.Tensor,
    activation: Callable = torch.relu,
    final_activation: Optional[Callable] = "same",
) -> torch.Tensor:
    """Apply the stack; ``final_activation`` defaults to the same activation
    (TF's per-layer activation), None gives a linear last layer."""
    n = len(params)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_activation == "same":
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x
