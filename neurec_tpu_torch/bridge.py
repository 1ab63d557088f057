"""Parameters and optimizer state between the packages, as numpy.

The JAX package's parameters (``{name: jnp.ndarray}``, or a list of
arrays under a name, as NGCF's per-layer weights) leave JAX as numpy
(``np.asarray``) and enter the port here, and back. Dtypes and list
structure are kept.

An optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, the latter two
structured as the params) goes into and out of the Adam state of
``trainer.OptaxAdam`` (``step``, ``exp_avg``, ``exp_avg_sq``, the keys of
``torch.optim.Adam``), so that a run can go on in either package from the
other's state.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


def map_params(fn: Callable, params: dict) -> dict:
    """``fn`` applied to every array of ``params``, keeping its structure."""
    return {name: [fn(v) for v in value] if isinstance(value, list) else fn(value)
            for name, value in params.items()}


def param_leaves(params: dict) -> Iterator[Tuple[Tuple, object]]:
    """``((name,) or (name, index), array)`` for every array of ``params``."""
    for name, value in params.items():
        if isinstance(value, list):
            for i, v in enumerate(value):
                yield (name, i), v
        else:
            yield (name,), value


def _at(tree: dict, path: Tuple):
    node = tree[path[0]]
    return node[path[1]] if len(path) > 1 else node


def params_from_numpy(params: dict, device: DeviceLike = None) -> Tree:
    """A copy on ``device``: training updates the tensors in place, which
    must not reach the caller's arrays."""
    dev = resolve_device(device)
    return map_params(lambda v: torch.from_numpy(np.array(v)).to(dev), params)


def params_to_numpy(params: Tree) -> dict:
    return map_params(lambda v: v.detach().cpu().numpy(), params)


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: Tree, count, mu: dict, nu: dict) -> None:
    """Load optax Adam moments into ``optimizer``, whose tensors are those
    of ``params`` (its step count lives on the host)."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if held != {id(p) for _, p in param_leaves(params)}:
        raise ValueError("the optimizer's tensors are not those of params")
    for path, p in param_leaves(params):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(_at(mu, path), dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(_at(nu, path), dtype=np.float32)).to(p.device),
        }


def adam_state_to_numpy(optimizer: torch.optim.Optimizer, params: Tree) -> Tuple[np.ndarray, dict, dict]:
    """``(count, mu, nu)`` of ``optimizer`` as an optax ``ScaleByAdamState``
    holds them: an int32 step count and moments structured as ``params``
    (count 0 and zero moments before the first step)."""
    steps = set()

    def moments(p):
        state = optimizer.state.get(p)
        if not state:
            state = {"step": 0, "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        steps.add(int(state["step"]))
        return state["exp_avg"].detach().cpu().numpy(), state["exp_avg_sq"].detach().cpu().numpy()

    both = map_params(moments, params)
    mu = map_params(lambda m: m[0], both)
    nu = map_params(lambda m: m[1], both)
    if len(steps) != 1:
        raise ValueError("Adam state steps differ across parameters: %s" % sorted(steps))
    return np.asarray(steps.pop(), dtype=np.int32), mu, nu

