"""The interaction data of a configuration, read and split by the benchmark.

A configuration names a rating file (``data.file``: one ``user,item`` pair
a line) and a split (``data.split``). The benchmark reads the file, maps
users and items to dense ids in sorted order of their raw ids, and splits
each user's items at random into the first ``ceil(ratio * n)`` for
training and the rest for testing, from a fixed seed of its own, so that
every run of a configuration sees the same data whatever its ``--seed``.
The same matrices go to the program (as an in-memory dataset) and to the
reference.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
from scipy.sparse import csr_matrix


class Split(NamedTuple):
    train: csr_matrix  # (users, items) of ones, sorted indices
    test: csr_matrix

    @property
    def num_users(self) -> int:
        return self.train.shape[0]

    @property
    def num_items(self) -> int:
        return self.train.shape[1]


def read_pairs(path: str) -> np.ndarray:
    """(n, 2) int64 ``user,item`` pairs of a comma-separated file."""
    with open(path, "rb") as fin:
        flat = np.array(fin.read().replace(b"\n", b",").split(b",")[:-1] or [], dtype=np.int64)
    if flat.size % 2:
        raise ValueError("%s: a line is not a user,item pair" % path)
    return flat.reshape(-1, 2)


def _csr(users, items, shape) -> csr_matrix:
    m = csr_matrix((np.ones(len(users), np.float32), (users, items)), shape=shape)
    m.sum_duplicates()
    m.data[:] = 1.0
    m.sort_indices()
    return m


def split_ratio(pairs: np.ndarray, ratio: float, seed: int) -> Split:
    """Each user's items in a random order (``RandomState(seed)``), the
    first ``ceil(ratio * n)`` to train, the rest to test."""
    users = np.unique(pairs[:, 0], return_inverse=True)[1].ravel()
    items_raw, items = np.unique(pairs[:, 1], return_inverse=True)
    items = items.ravel()
    shape = (int(users.max()) + 1, len(items_raw))
    order = np.lexsort((np.random.RandomState(seed).random_sample(len(users)), users))
    u, i = users[order], items[order]
    starts = np.searchsorted(u, np.arange(shape[0]))
    sizes = np.diff(np.append(starts, len(u)))
    rank = np.arange(len(u)) - np.repeat(starts, sizes)
    is_train = rank < np.repeat(np.ceil(ratio * sizes).astype(np.int64), sizes)
    return Split(_csr(u[is_train], i[is_train], shape), _csr(u[~is_train], i[~is_train], shape))


def load(root: str, spec: dict) -> Split:
    """The split a configuration's ``data`` entry states."""
    pairs = read_pairs(os.path.join(root, spec["file"]))
    split = spec["split"]
    if split["kind"] != "ratio":
        raise ValueError("split kind %r" % split["kind"])
    return split_ratio(pairs, float(split["ratio"]), int(split["seed"]))


def flat_train(train: csr_matrix):
    """Each train interaction as (user, item), user by user, items in
    ascending order: instance ``n`` of a pairwise epoch."""
    users = np.repeat(np.arange(train.shape[0]), np.diff(train.indptr))
    return users.astype(np.int64), train.indices.astype(np.int64)
