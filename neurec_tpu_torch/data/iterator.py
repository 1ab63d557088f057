"""DataIterator — host-side minibatch iterator (port of
``neurec_tpu/data/iterator.py``; API parity: util/data_iterator.py:25-210).

The trainer does not use this (its epochs draw on the device), but the
reference exposes it as a public utility for custom loops and eval batching,
so it is provided with the same semantics: N parallel sequences, optional
shuffling (``np.random.permutation``), optional drop_last, batches yielded
as transposed tuples.
"""

from __future__ import annotations

import numpy as np


class DataIterator:
    def __init__(self, *data, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False):
        if not data:
            raise ValueError("at least one data sequence is required")
        lengths = {len(d) for d in data}
        if len(lengths) != 1:
            raise ValueError("all data sequences must have equal length")
        # keep sequences as given (the reference does the same): an eager
        # list() of a few-million-element int32 array boxes every element
        # into a Python object (~30x memory) before the first batch.
        # pandas objects index by LABEL, not position — a filtered
        # Series would yield wrong rows — so those convert to numpy.
        self._data = [
            d.to_numpy() if hasattr(d, "iloc") else d for d in data
        ]
        self._n = lengths.pop()
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.random.permutation(self._n) if self.shuffle else range(self._n)
        order = list(order)
        B = self.batch_size
        for start in range(0, self._n, B):
            idx = order[start : start + B]
            if self.drop_last and len(idx) < B:
                return
            batch = [[seq[i] for i in idx] for seq in self._data]
            if len(self._data) == 1:
                yield batch[0]
            else:
                yield tuple(batch)
