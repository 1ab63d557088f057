"""Parameters and optimizer state between the packages, as numpy.

The JAX package's parameters are a tree of dicts and lists of arrays
(``{name: array}``, a list of arrays under a name as NGCF's per-layer
weights, or a list of dicts as the towers' ``[{"w", "b"}]``). They leave
JAX as numpy (``np.asarray``) and enter the port here, and back. Key
names, dtypes and the nesting are kept; a leaf's path is the tuple of
keys and list indices that reaches it.

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

Tree = Union[Dict[str, "Tree"], List["Tree"], torch.Tensor]


def map_params(fn: Callable, params):
    """``fn`` applied to every leaf of ``params``, keeping its structure
    (dicts stay dicts, lists and tuples become lists)."""
    if isinstance(params, dict):
        return {name: map_params(fn, value) for name, value in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(fn, value) for value in params]
    return fn(params)


def param_leaves(params, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """``(path, leaf)`` for every leaf of ``params``, e.g. ``("user_emb",)``,
    ``("W_gc", 0)`` or ``("tower", 1, "w")``."""
    if isinstance(params, dict):
        for name, value in params.items():
            yield from param_leaves(value, prefix + (name,))
    elif isinstance(params, (list, tuple)):
        for i, value in enumerate(params):
            yield from param_leaves(value, prefix + (i,))
    else:
        yield prefix, params


def _at(tree, path: Tuple):
    for part in path:
        tree = tree[part]
    return tree


def params_from_numpy(params, device: DeviceLike = None) -> Tree:
    """A copy on ``device``: training updates the tensors in place, which
    must not reach the caller's arrays."""
    dev = resolve_device(device)
    return map_params(lambda v: torch.from_numpy(np.array(v)).to(dev), params)


def params_to_numpy(params: Tree, shards=None):
    """The params as numpy, whole: under a mesh whose tables are sharded
    over 'model' (``shards``, the model's ``Recommender.shards``) each
    sharded leaf is gathered first, a collective that every rank calls
    (``parallel/tables.py``)."""
    if shards:
        from neurec_tpu_torch.parallel.tables import gather_tree

        params = gather_tree(params, shards)
    return map_params(lambda v: v.detach().cpu().numpy(), params)


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: Tree, count, mu, nu) -> None:
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


def adam_state_to_numpy(optimizer: torch.optim.Optimizer, params: Tree) -> Tuple[np.ndarray, object, object]:
    """``(count, mu, nu)`` of ``optimizer`` as an optax ``ScaleByAdamState``
    holds them: an int32 step count and moments structured as ``params``
    (count 0 and zero moments before the first step)."""
    steps = set()

    def moment(key):
        def get(p):
            state = optimizer.state.get(p)
            if not state:
                state = {"step": 0, "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            steps.add(int(state["step"]))
            return state[key].detach().cpu().numpy()
        return get

    mu = map_params(moment("exp_avg"), params)
    nu = map_params(moment("exp_avg_sq"), params)
    if len(steps) != 1:
        raise ValueError("Adam state steps differ across parameters: %s" % sorted(steps))
    return np.asarray(steps.pop(), dtype=np.int32), mu, nu
