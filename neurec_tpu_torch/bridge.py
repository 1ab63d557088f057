"""Parameters and optimizer state between the packages, as numpy.

The JAX package's parameters (``{name: jnp.ndarray}``) leave JAX as numpy
(``np.asarray``) and enter the port here, and back. Dtypes are kept.

An optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, the latter two
keyed as the params) goes into and out of ``torch.optim.Adam``'s state
(``step``, ``exp_avg``, ``exp_avg_sq``), so that a run can go on in either
package from the other's state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device


def params_from_numpy(
    params: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """A copy on ``device``: training updates the tensors in place, which
    must not reach the caller's arrays."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(value)).to(dev) for name, value in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: value.detach().cpu().numpy() for name, value in params.items()}


def adam_state_from_numpy(
    optimizer: torch.optim.Adam,
    params: Dict[str, torch.Tensor],
    count,
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
) -> None:
    """Load optax Adam moments into ``optimizer``, whose tensors are those
    of ``params`` (a plain ``torch.optim.Adam``: its step count lives on
    the host)."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if held != {id(p) for p in params.values()}:
        raise ValueError("the optimizer's tensors are not those of params")
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[name], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], dtype=np.float32)).to(p.device),
        }


def adam_state_to_numpy(
    optimizer: torch.optim.Adam, params: Dict[str, torch.Tensor]
) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``(count, mu, nu)`` of ``optimizer`` as an optax ``ScaleByAdamState``
    holds them: an int32 step count and moments keyed as ``params`` (count
    0 and zero moments before the first step)."""
    steps, mu, nu = set(), {}, {}
    for name, p in params.items():
        state = optimizer.state.get(p)
        if not state:
            state = {"step": 0, "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        steps.add(int(state["step"]))
        mu[name] = state["exp_avg"].detach().cpu().numpy()
        nu[name] = state["exp_avg_sq"].detach().cpu().numpy()
    if len(steps) != 1:
        raise ValueError("Adam state steps differ across parameters: %s" % sorted(steps))
    return np.asarray(steps.pop(), dtype=np.int32), mu, nu

