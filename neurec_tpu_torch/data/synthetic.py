"""In-memory datasets (no files) — for tests and dry runs.

Copy of ``neurec_tpu/data/synthetic.py``: the same ``RandomState`` draws,
so a seed gives the same dataset in both packages.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix

from neurec_tpu_torch.data.dataset import csr_to_user_dict, csr_to_user_dict_bytime


class InMemoryDataset:
    """Duck-typed stand-in for data.Dataset built from CSR matrices."""

    def __init__(
        self,
        train_matrix: csr_matrix,
        test_matrix: csr_matrix,
        time_matrix: csr_matrix = None,
        negative_matrix: csr_matrix = None,
        name: str = "synthetic",
    ):
        self.train_matrix = train_matrix
        self.test_matrix = test_matrix
        self.time_matrix = time_matrix
        self.negative_matrix = negative_matrix
        self.dataset_name = name
        self.num_users, self.num_items = train_matrix.shape
        self.num_ratings = train_matrix.nnz + test_matrix.nnz

    def get_user_train_dict(self, by_time: bool = False):
        if by_time:
            if self.time_matrix is None:
                raise ValueError("no time matrix")
            return csr_to_user_dict_bytime(self.time_matrix, self.train_matrix)
        return csr_to_user_dict(self.train_matrix)

    def get_user_test_dict(self):
        return csr_to_user_dict(self.test_matrix)

    def get_user_test_neg_dict(self):
        if self.negative_matrix is None:
            return None
        return csr_to_user_dict(self.negative_matrix)

    def get_train_interactions(self):
        coo = self.train_matrix.tocoo()
        return coo.row.tolist(), coo.col.tolist()

    def to_csr_matrix(self):
        return self.train_matrix.copy()


def random_dataset(
    num_users: int = 64,
    num_items: int = 128,
    min_per_user: int = 4,
    max_per_user: int = 16,
    n_test: int = 2,
    seed: int = 0,
    with_time: bool = True,
) -> InMemoryDataset:
    """Random implicit-feedback dataset with a train/test split."""
    rng = np.random.RandomState(seed)
    tr_u, tr_i, tr_t = [], [], []
    te_u, te_i = [], []
    for u in range(num_users):
        n = rng.randint(min_per_user, max_per_user + 1)
        items = rng.choice(num_items, size=n, replace=False)
        split = max(1, n - n_test)
        for t, i in enumerate(items[:split]):
            tr_u.append(u)
            tr_i.append(i)
            tr_t.append(t + 1)
        for i in items[split:]:
            te_u.append(u)
            te_i.append(i)
    shape = (num_users, num_items)
    train = csr_matrix((np.ones(len(tr_u), np.float32), (tr_u, tr_i)), shape=shape)
    test = csr_matrix((np.ones(len(te_u), np.float32), (te_u, te_i)), shape=shape)
    time = (
        csr_matrix((np.asarray(tr_t, np.float32), (tr_u, tr_i)), shape=shape)
        if with_time
        else None
    )
    return InMemoryDataset(train, test, time)


class DictConfig:
    """Minimal Config stand-in over a plain dict (for tests/dry runs)."""

    def __init__(self, values: dict):
        self._values = dict(values)

    def __getitem__(self, key):
        return self._values[key]

    def __contains__(self, key):
        return key in self._values

    def get(self, key, default=None):
        return self._values.get(key, default)

    def get_raw(self, key, default=None):
        return self._values.get(key, default)

    def params_str(self):
        return str(self._values.get("recommender", "model"))
