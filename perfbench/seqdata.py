"""A seeded timestamped interaction set at a public set's shape, and its
leave-one-out split, in NumPy alone.

A configuration's ``data`` entry of kind ``synthetic_seq`` gives the
shape: users, items, interactions, each user's least count, the counts'
median, the largest count, the items' popularity exponent and offset, the
time span, and the generator's own seed (every run of a configuration sees
the same data, whatever its ``--seed``):

* counts: ``min_per_user`` plus a lognormal whose median and mean give the
  stated median and ``interactions / users``, capped at ``max_per_user``,
  then moved by ones over random users until they sum to ``interactions``;
* items: distinct within a user, drawn by a Zipf-like popularity, the
  density ``(rank + offset) ** -exponent`` over ranks [0, items) floored,
  over a fixed random order of the ids;
  draws that repeat a user's item are drawn again, and a user still short
  after a few rounds takes the rest uniformly from the items it lacks;
* times: integer seconds, strictly increasing within a user, from a start
  uniform over the span by lognormal gaps (heavy-tailed), scaled down
  where a user's history would pass the span's end;
* the split: each user's last action (by time) to test, the rest to train.

The same arrays go to the port (an in-memory dataset with its train and
test time matrices) and to the reference (``histories``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.sparse import csr_matrix

TOPUP_ROUNDS = 6


class SeqSplit(NamedTuple):
    starts: np.ndarray   # (users + 1,) offsets of each user's actions in the flat arrays
    items: np.ndarray    # (interactions,) int64, each user's in time order
    times: np.ndarray    # (interactions,) int64 seconds
    num_items: int

    @property
    def num_users(self) -> int:
        return len(self.starts) - 1

    @property
    def num_interactions(self) -> int:
        return len(self.items)

    def train_mask(self) -> np.ndarray:
        """True at every action but each user's last."""
        keep = np.ones(len(self.items), dtype=bool)
        keep[self.starts[1:] - 1] = False
        return keep

    def matrices(self):
        """(train, train times, test, test times) CSR matrices, (users,
        items), sorted indices: ones, and the actions' times."""
        keep = self.train_mask()
        users = np.repeat(np.arange(self.num_users), np.diff(self.starts))
        shape = (self.num_users, self.num_items)
        out = []
        for sel in (keep, ~keep):
            indptr = np.concatenate([[0], np.cumsum(np.bincount(users[sel], minlength=self.num_users))])
            t = csr_matrix((self.times[sel].astype(np.float64), self.items[sel], indptr), shape=shape)
            t.sort_indices()
            ones = csr_matrix((np.ones(t.nnz, np.float32), t.indices.copy(), t.indptr.copy()), shape=shape)
            out += [ones, t]
        return out[0], out[1], out[2], out[3]


def _counts(rng, spec) -> np.ndarray:
    U, total = int(spec["num_users"]), int(spec["num_interactions"])
    lo, hi = int(spec["min_per_user"]), int(spec["max_per_user"])
    median, mean = float(spec["median_per_user"]) - lo, total / U - lo
    sigma = np.sqrt(2.0 * np.log(mean / median))
    n = lo + np.floor(rng.lognormal(np.log(median), sigma, U)).astype(np.int64)
    n = np.clip(n, lo, hi)
    while True:  # ones over random users until the total is the stated one
        diff = total - int(n.sum())
        if diff == 0:
            return n
        pick = rng.randint(0, U, abs(diff))
        room = n[pick] < hi if diff > 0 else n[pick] > lo
        np.add.at(n, pick[room], 1 if diff > 0 else -1)


def _items(rng, spec, n: np.ndarray) -> np.ndarray:
    """Distinct Zipf-like items of each user, user by user, in a random
    order within a user."""
    I = int(spec["num_items"])
    order = rng.permutation(I)
    a, e = float(spec["popularity_offset"]), float(spec["popularity_exponent"])

    def draw(m):
        """Ranks of density (x + a) ** -e over [0, I), by its inverse CDF,
        floored, then the ids of those ranks."""
        u = rng.random_sample(m)
        if e == 1.0:
            x = a * ((I + a) / a) ** u - a
        else:
            x = (a ** (1 - e) + u * ((I + a) ** (1 - e) - a ** (1 - e))) ** (1 / (1 - e)) - a
        return order[np.clip(x.astype(np.int64), 0, I - 1)]

    U = len(n)
    codes = _unique(np.repeat(np.arange(U, dtype=np.int64), n) * I + draw(int(n.sum())))
    # the top-up: a user's fresh draws are held apart from ``codes`` and
    # merged once at the end, its counts kept as they grow
    have = np.bincount(codes // I, minlength=U)
    added = np.zeros(0, np.int64)
    for _ in range(TOPUP_ROUNDS):
        short = n - have
        if not short.any():
            break
        need = np.repeat(np.arange(U, dtype=np.int64), short * 2)
        new = _unique(need * I + draw(len(need)))
        new = new[~(_member(codes, new) | _member(added, new))]
        u = new // I
        rank = np.arange(len(new)) - np.searchsorted(u, u)  # a user's new items, in order
        new = new[rank < short[u]]
        have += np.bincount(new // I, minlength=U)
        added = np.sort(np.concatenate([added, new]))
    codes = _merge(codes, added)
    extra = []
    for user in np.flatnonzero(have < n):  # the few heavy users still short
        lo, hi = np.searchsorted(codes, [user * I, (user + 1) * I])
        free = np.setdiff1d(np.arange(I), codes[lo:hi] % I, assume_unique=True)
        extra.append(user * I + rng.choice(free, n[user] - have[user], replace=False))
    if extra:
        codes = _merge(codes, np.sort(np.concatenate(extra)))
    # each user's items in a random order: sort by (user, a random key)
    users = codes // I
    key = (users << 32) | rng.randint(0, 2 ** 31, len(codes)).astype(np.int64)
    return (codes - users * I)[np.argsort(key)]


def _unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` by a sort: NumPy 2.3's ``np.unique`` hashes an
    integer array first, many times slower than a sort over ML-20M's 20 M
    codes (``PERF.md``)."""
    x = np.sort(x)
    keep = np.ones(len(x), dtype=bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def _member(sorted_codes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """True where ``x`` is in ``sorted_codes`` (ascending)."""
    if not len(sorted_codes):
        return np.zeros(len(x), dtype=bool)
    at = np.searchsorted(sorted_codes, x)
    return sorted_codes[np.minimum(at, len(sorted_codes) - 1)] == x


def _merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two ascending arrays with no common value, merged: one pass over
    ``a``, not a sort."""
    return np.insert(a, np.searchsorted(a, b), b) if len(b) else a


def _times(rng, spec, n: np.ndarray) -> np.ndarray:
    t0, t1 = int(spec["time_start"]), int(spec["time_end"])
    U = len(n)
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    # floor of a positive lognormal: its truncation
    gaps = 1 + rng.lognormal(float(spec["gap_log_median"]), float(spec["gap_log_sigma"]),
                             int(n.sum())).astype(np.int64)
    gaps[first] = 0
    span = np.add.reduceat(gaps, first)
    begin = t0 + np.floor(rng.random_sample(U) * (t1 - t0)).astype(np.int64)
    room = np.maximum(t1 - begin, n - 1)
    # a history that would pass the end is squeezed: gaps scaled, kept >= 1
    # (a scale of 1 leaves a gap as it is; only the squeezed users are touched)
    scale = np.minimum(1.0, (room - (n - 1)) / np.maximum(span - (n - 1), 1))
    squeezed = np.flatnonzero(scale < 1.0)
    at = np.repeat(first[squeezed], n[squeezed]) + _ranks(n[squeezed])
    gaps[at] = 1 + np.floor((gaps[at] - 1) * np.repeat(scale[squeezed], n[squeezed])).astype(np.int64)
    gaps[first] = 0
    c = np.cumsum(gaps)
    return c + np.repeat(begin - c[first], n)


def _ranks(n: np.ndarray) -> np.ndarray:
    """0 .. n_u - 1 for each entry of ``n``, flat."""
    return np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)


def generate(spec: dict) -> SeqSplit:
    """The set a configuration's ``data`` entry states (module docstring)."""
    rng = np.random.RandomState(int(spec["seed"]))
    n = _counts(rng, spec)
    items = _items(rng, spec, n)
    times = _times(rng, spec, n)
    starts = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    return SeqSplit(starts, items.astype(np.int64), times, int(spec["num_items"]))


def histories(split: SeqSplit, users: np.ndarray, N: int):
    """The evaluation's inputs of ``users`` from the split itself: (seq (B,
    N) int64 right-padded with ``num_items``, lengths (B,), ts (B, N + 1)
    int64), each user's last N train actions by time and the test action's
    time at the slot after them."""
    pad = split.num_items
    B = len(users)
    seq = np.full((B, N), pad, np.int64)
    ts = np.zeros((B, N + 1), np.int64)
    lengths = np.zeros(B, np.int64)
    lo, test = split.starts[users], split.starts[users + 1] - 1
    n = np.minimum(test - lo, N)
    col = np.arange(N)[None, :]
    idx = (test - n)[:, None] + col
    real = col < n[:, None]
    seq[real] = split.items[idx[real]]
    ts[:, :N][real] = split.times[idx[real]]
    ts[np.arange(B), n] = split.times[test]
    lengths[:] = n
    return seq, lengths, ts
