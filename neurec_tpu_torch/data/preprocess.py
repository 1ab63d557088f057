"""Host-side dataset preprocessing: read, filter, split, remap, md5 — numpy only.

A numpy rewrite of the JAX package's pandas pipeline
(``neurec_tpu/data/preprocess.py``) that gives the identical split and
id maps for the same file and seed:

* a table is a dict ``{column: 1-D array}``; ``read_table`` infers each
  column's dtype the way ``pandas.read_csv`` does for these files (int64
  when every field is an integer, float64 when every field is a number or
  missing, str otherwise) and skips blank lines;
* ``filter_data``: drop rows with a missing field, then items with
  < item_min rows, then users with < user_min rows;
* ``split_by_ratio``: stable sort by (user, time), or by (user, item)
  followed by the ``RandomState(seed).permutation`` shuffle and a stable
  re-sort by user; then the first ceil(ratio*n) rows of each user train;
* ``split_by_loo``: the last row of each user with > 3 rows is test;
* ``remap_ids``: dense ids by first appearance over train + test.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Table = Dict[str, np.ndarray]


def check_md5(file_name: str) -> str:
    if not os.path.isfile(file_name):
        raise FileNotFoundError("There is no file named '%s'!" % file_name)
    with open(file_name, "rb") as fin:
        return hashlib.md5(fin.read()).hexdigest()


def _parse_column(fields: List[str]) -> np.ndarray:
    """pandas-style dtype inference for one column of raw fields."""
    raw = np.asarray(fields, dtype=str)
    missing = raw == ""
    if not missing.any():
        try:
            return raw.astype(np.int64)
        except ValueError:
            pass
    try:
        return np.where(missing, "nan", raw).astype(np.float64)
    except ValueError:
        out = raw.astype(object)
        out[missing] = None
        return out


def read_table(path: str, sep: str, names: Sequence[str]) -> Table:
    """Headerless ``sep``-separated file -> ``{name: column}``."""
    with open(path, "r") as fin:
        rows = [line.split(sep) for line in fin.read().splitlines() if line]
    return {
        name: _parse_column([r[j] if j < len(r) else "" for r in rows])
        for j, name in enumerate(names)
    }


def num_rows(data: Table) -> int:
    return len(next(iter(data.values())))


def take(data: Table, index) -> Table:
    return {name: col[index] for name, col in data.items()}


def concat(a: Table, b: Table) -> Table:
    return {name: np.concatenate([a[name], b[name]]) for name in a}


def _present(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.asarray([v is not None for v in col], dtype=bool)
    if col.dtype.kind == "f":
        return ~np.isnan(col)
    return np.ones(len(col), dtype=bool)


def _counts_per_row(col: np.ndarray) -> np.ndarray:
    _, inverse, counts = np.unique(col, return_inverse=True, return_counts=True)
    return counts[inverse.ravel()]


def filter_data(
    data: Table, user_min: Optional[int] = None, item_min: Optional[int] = None
) -> Table:
    keep = np.ones(num_rows(data), dtype=bool)
    for col in data.values():
        keep &= _present(col)
    data = take(data, keep)
    if item_min is not None and item_min > 0:
        data = take(data, _counts_per_row(data["item"]) >= item_min)
    if user_min is not None and user_min > 0:
        data = take(data, _counts_per_row(data["user"]) >= user_min)
    return data


def _rank(col: np.ndarray) -> np.ndarray:
    """Dense rank of each value in sorted order (works for str columns)."""
    return np.unique(col, return_inverse=True)[1].ravel().astype(np.int64)


def _stable_order(*keys: np.ndarray) -> np.ndarray:
    """Stable argsort by the given keys, the first key primary."""
    key = np.zeros(len(keys[0]), dtype=np.int64)
    for col in keys:
        r = _rank(col)
        key = key * (int(r.max(initial=-1)) + 1) + r
    return np.argsort(key, kind="stable")


def _sorted_per_user(data: Table, by_time: bool, rng: np.random.RandomState) -> Table:
    if by_time:
        return take(data, _stable_order(data["user"], data["time"]))
    # sort for per-user grouping, then shuffle within the user group
    data = take(data, _stable_order(data["user"], data["item"]))
    data = take(data, rng.permutation(num_rows(data)))
    return take(data, _stable_order(data["user"]))


def _user_runs(user: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, size) of each run of equal users, in order."""
    n = len(user)
    change = np.ones(n, dtype=bool)
    change[1:] = user[1:] != user[:-1]
    starts = np.flatnonzero(change)
    sizes = np.diff(np.append(starts, n))
    return starts, sizes


def split_by_ratio(
    data: Table, ratio: float = 0.8, by_time: bool = True, seed: int = 2018
) -> Tuple[Table, Table]:
    rng = np.random.RandomState(seed)
    data = _sorted_per_user(data, by_time, rng)
    starts, sizes = _user_runs(data["user"])
    cut = np.ceil(ratio * sizes).astype(np.int64)
    rank = np.arange(num_rows(data)) - np.repeat(starts, sizes)
    is_train = rank < np.repeat(cut, sizes)
    return take(data, is_train), take(data, ~is_train)


def split_by_loo(
    data: Table, by_time: bool = True, seed: int = 2018
) -> Tuple[Table, Table]:
    rng = np.random.RandomState(seed)
    data = _sorted_per_user(data, by_time, rng)
    starts, sizes = _user_runs(data["user"])
    rank = np.arange(num_rows(data)) - np.repeat(starts, sizes)
    size_per_row = np.repeat(sizes, sizes)
    # users with <= 3 interactions keep everything in train
    is_test = (rank == size_per_row - 1) & (size_per_row > 3)
    return take(data, ~is_test), take(data, is_test)


def _first_appearance(col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique values in order of first appearance, dense id of each row)."""
    uniq, first, inverse = np.unique(col, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    ids = np.empty(len(uniq), dtype=np.int64)
    ids[order] = np.arange(len(uniq), dtype=np.int64)
    return uniq[order], ids[inverse.ravel()]


def remap_ids(train: Table, test: Table):
    """Densely remap user/item ids by first appearance over train+test.

    Returns (train, test, user2id, item2id).
    """
    n_train = num_rows(train)
    both = concat(train, test)
    maps = {}
    for name in ("user", "item"):
        uniq, ids = _first_appearance(both[name])
        both[name] = ids
        maps[name] = dict(zip(uniq.tolist(), range(len(uniq))))
    train = take(both, slice(0, n_train))
    test = take(both, slice(n_train, None))
    return train, test, maps["user"], maps["item"]
