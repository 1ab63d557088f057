"""Host-side utilities mirroring the reference's util/tool.py surface
(port of ``neurec_tpu/utils.py``).

Device-side equivalents live in ops/ (sampling, metrics, losses); these are
the numpy/host versions kept for API parity and host tooling. The draws are
numpy's, on the global ``np.random`` stream, as in the JAX package: the same
``np.random.seed`` gives the same draws in both.
"""

from __future__ import annotations

import inspect
from functools import wraps
from typing import Optional, Sequence

import numpy as np


def randint_choice(
    high: int,
    size: Optional[int] = None,
    replace: bool = True,
    p=None,
    exclusion: Optional[Sequence[int]] = None,
):
    """Uniform (or weighted) sampling from [0, high) with optional exclusion
    (parity: util/tool.py:116-129 — exclusion via zeroed probabilities)."""
    a = np.arange(high)
    if exclusion is not None:
        if p is None:
            p = np.ones(high)
        else:
            p = np.array(p, dtype=float)
        p[np.asarray(list(exclusion), dtype=np.int64)] = 0
    if p is not None:
        p = np.asarray(p, dtype=float)
        p = p / p.sum()
    sample = np.random.choice(a, size=size, replace=replace, p=p)
    return sample


def typeassert(*type_args, **type_kwargs):
    """Runtime argument type checking decorator (parity: util/tool.py:132-146).

    Accepts types or tuples of types; None entries in a tuple mean NoneType.
    """

    def decorate(func):
        sig = inspect.signature(func)
        bound = sig.bind_partial(*type_args, **type_kwargs).arguments

        def _norm(t):
            if isinstance(t, tuple):
                return tuple(type(None) if x is None else x for x in t)
            return type(None) if t is None else t

        checks = {name: _norm(t) for name, t in bound.items()}

        @wraps(func)
        def wrapper(*args, **kwargs):
            values = sig.bind(*args, **kwargs).arguments
            for name, value in values.items():
                if name in checks and not isinstance(value, checks[name]):
                    raise TypeError(
                        "Argument %r must be %s" % (name, checks[name])
                    )
            return func(*args, **kwargs)

        return wrapper

    return decorate


def inner_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise dot product (parity: util/tool.py:198-200)."""
    return np.sum(a * b, axis=-1)


def argmax_top_k(a, top_k: int = 50):
    """Indices of the top_k largest values, ties by lower index
    (parity: util/tool.py:149-151)."""
    a = np.asarray(a)
    idx = np.argpartition(-a, min(top_k, len(a) - 1))[:top_k]
    # argpartition scrambles tie order; sort by (-value, index)
    return idx[np.lexsort((idx, -a[idx]))]
