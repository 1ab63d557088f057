"""Dataset: load / filter / split / remap / cache, backed by scipy CSR.

Port of ``neurec_tpu/data/dataset.py`` in numpy and scipy alone. It
writes and reads the same cache files under ``data.cache.path``
(``_tmp_<name>/<name>_<splitter>_u<min>_i<min>[_by_time].{train,test,
user2id,item2id,md5,info}``) and exposes the same ``train_matrix``,
``test_matrix``, ``time_matrix``, ``get_user_*_dict`` and ``__str__``.

The sampled-candidates protocol (``neurec_tpu/data/dataset.py:244-330``):

* a shipped ``<name>.neg`` (a user id, then that user's test negatives, on
  each line) is remapped through the id maps beside the split cache, as
  ``<prefix>.neg<N>``; ids are matched as the JAX package's
  ``_remap_token`` matches them, on the values its pandas reader would
  give (one dtype for the whole file: object where a column holds text,
  else float where a column has a gap, else int). A ragged line raises
  ``ValueError``; so does an empty or whitespace-only file, naming the
  dataset (the JAX package raises pandas' ``EmptyDataError``, a
  ``ValueError``);
* ``rec.evaluate.neg = N > 0``: ``<prefix>.neg<N>`` is read, or made from
  ``RandomState(seed)``: user by user in sorted order, N items drawn
  without replacement from those the user never rated (train or test).
  The file is byte-equal to the JAX package's; ``negative_matrix`` holds
  it as a CSR of ones, and ``get_user_test_neg_dict`` as lists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from scipy.sparse import csr_matrix

from neurec_tpu_torch.data.preprocess import (
    _parse_column,
    check_md5,
    concat,
    filter_data,
    num_rows,
    read_table,
    remap_ids,
    split_by_loo,
    split_by_ratio,
)

_FORMATS = {
    "UIRT": ["user", "item", "rating", "time"],
    "UIR": ["user", "item", "rating"],
    "UI": ["user", "item"],
    "UIT": ["user", "item", "time"],
}


def csr_to_user_dict(matrix: csr_matrix) -> Dict[int, List[int]]:
    """{user: [items]} for users with at least one entry."""
    out: Dict[int, List[int]] = {}
    indptr, indices = matrix.indptr, matrix.indices
    for u in range(matrix.shape[0]):
        row = indices[indptr[u] : indptr[u + 1]]
        if len(row):
            out[u] = row.tolist()
    return out


def csr_to_user_dict_bytime(
    time_matrix: csr_matrix, train_matrix: csr_matrix
) -> Dict[int, List[int]]:
    """Items per user sorted ascending by timestamp."""
    out: Dict[int, List[int]] = {}
    indptr, indices, times = time_matrix.indptr, time_matrix.indices, time_matrix.data
    for u in range(time_matrix.shape[0]):
        lo, hi = indptr[u], indptr[u + 1]
        if hi > lo:
            order = np.argsort(times[lo:hi], kind="stable")
            out[u] = indices[lo:hi][order].tolist()
    return out


def read_neg_rows(path: str, sep: str, dataset_name: str) -> list:
    """The rows of a ``.neg`` file as the JAX package's ``pd.read_csv(...,
    header=None).values`` gives them: columns typed as ``read_table`` types
    them, then one dtype for all (object if any column holds text, else
    float if any has a gap, else int). Blank and whitespace-only lines are
    skipped; a line longer than the first, or no line at all, raises
    ``ValueError``."""
    with open(path, "r") as fin:
        rows = [line.split(sep) for line in fin.read().splitlines() if line.strip()]
    if not rows:
        raise ValueError("%s.neg is empty: it holds no user and no negative" % dataset_name)
    width = len(rows[0])
    if any(len(r) > width for r in rows):
        raise ValueError("ragged line in %s.neg (a line has more fields than the first)" % dataset_name)
    cols = [_parse_column([r[j] if j < len(r) else "" for r in rows]) for j in range(width)]
    if any(c.dtype == object for c in cols):
        cols = [c.astype(object) for c in cols]
    elif any(c.dtype.kind == "f" for c in cols):
        cols = [c.astype(np.float64) for c in cols]
    return [list(r) for r in zip(*(c.tolist() for c in cols))]


class Dataset:
    def __init__(self, config, seed: int = 2018):
        self.dataset_name = config["data.input.dataset"]
        self.train_matrix: Optional[csr_matrix] = None
        self.test_matrix: Optional[csr_matrix] = None
        self.time_matrix: Optional[csr_matrix] = None
        self.negative_matrix: Optional[csr_matrix] = None
        self.userids: Optional[Dict] = None
        self.itemids: Optional[Dict] = None
        self.num_users = 0
        self.num_items = 0
        self.num_ratings = 0
        self._seed = seed
        self._load_data(config)

    # -- paths -------------------------------------------------------------
    def _get_paths(self, config):
        data_path = config["data.input.path"]
        ori_prefix = os.path.join(data_path, self.dataset_name)
        cache_root = config.get("data.cache.path", data_path)
        saved_dir = os.path.join(cache_root, "_tmp_" + self.dataset_name)
        saved_prefix = "%s_%s_u%d_i%d" % (
            self.dataset_name,
            config["splitter"],
            config["user_min"],
            config["item_min"],
        )
        if config.get("by_time", False) is True:
            saved_prefix += "_by_time"
        return ori_prefix, os.path.join(saved_dir, saved_prefix)

    def _source_md5(self, splitter: str, ori_prefix: str) -> List[str]:
        if splitter in ("loo", "ratio"):
            return [check_md5(ori_prefix + ".rating")]
        elif splitter == "given":
            return [check_md5(ori_prefix + ".train"), check_md5(ori_prefix + ".test")]
        raise ValueError("'%s' is an invalid splitter!" % splitter)

    def _cache_valid(self, splitter, ori_prefix, saved_prefix) -> bool:
        md5_file = saved_prefix + ".md5"
        if not os.path.isfile(md5_file):
            return False
        with open(md5_file, "r") as fin:
            saved = [line.strip() for line in fin.readlines()]
        if saved != self._source_md5(splitter, ori_prefix):
            return False
        return all(
            os.path.isfile(saved_prefix + sfx)
            for sfx in (".train", ".test", ".user2id", ".item2id")
        )

    # -- load --------------------------------------------------------------
    def _load_data(self, config):
        file_format = config["data.column.format"]
        if file_format not in _FORMATS:
            raise ValueError("'%s' is an invalid data column format!" % file_format)
        columns = _FORMATS[file_format]
        sep = config["data.convert.separator"]
        splitter = config["splitter"]
        ori_prefix, saved_prefix = self._get_paths(config)

        if self._cache_valid(splitter, ori_prefix, saved_prefix):
            train_data = read_table(saved_prefix + ".train", sep, columns)
            test_data = read_table(saved_prefix + ".test", sep, columns)
            user_map = read_table(saved_prefix + ".user2id", sep, ["user", "id"])
            item_map = read_table(saved_prefix + ".item2id", sep, ["item", "id"])
            self.userids = dict(zip(user_map["user"].tolist(), user_map["id"].tolist()))
            self.itemids = dict(zip(item_map["item"].tolist(), item_map["id"].tolist()))
        else:
            by_time = config.get("by_time", False) if file_format in ("UIRT", "UIT") else False
            train_data, test_data = self._split_data(
                ori_prefix, saved_prefix, columns, bool(by_time), config
            )

        all_data = concat(train_data, test_data)
        self.num_users = int(all_data["user"].max()) + 1
        self.num_items = int(all_data["item"].max()) + 1
        self.num_ratings = num_rows(all_data)

        if file_format in ("UI", "UIT"):
            train_ratings = np.ones(num_rows(train_data), dtype=np.float32)
            test_ratings = np.ones(num_rows(test_data), dtype=np.float32)
        else:
            train_ratings = train_data["rating"].astype(np.float32)
            test_ratings = test_data["rating"].astype(np.float32)

        shape = (self.num_users, self.num_items)
        self.train_matrix = csr_matrix(
            (train_ratings, (train_data["user"], train_data["item"])), shape=shape
        )
        self.test_matrix = csr_matrix(
            (test_ratings, (test_data["user"], test_data["item"])), shape=shape
        )
        if file_format in ("UIRT", "UIT"):
            self.time_matrix = csr_matrix(
                (train_data["time"], (train_data["user"], train_data["item"])),
                shape=shape,
            )
        self.negative_matrix = self._load_test_neg_items(all_data, config, saved_prefix, sep)

    def _split_data(self, ori_prefix, saved_prefix, columns, by_time, config):
        splitter = config["splitter"]
        sep = config["data.convert.separator"]
        os.makedirs(os.path.dirname(saved_prefix), exist_ok=True)

        if splitter in ("loo", "ratio"):
            all_data = read_table(ori_prefix + ".rating", sep, columns)
            filtered = filter_data(
                all_data, user_min=config["user_min"], item_min=config["item_min"]
            )
            if num_rows(filtered) == 0:
                raise ValueError(
                    "user_min=%s/item_min=%s filtered out all %d "
                    "interactions of %s.rating — relax the thresholds"
                    % (config["user_min"], config["item_min"],
                       num_rows(all_data), os.path.basename(ori_prefix))
                )
            if splitter == "ratio":
                train_data, test_data = split_by_ratio(
                    filtered, ratio=config["ratio"], by_time=by_time, seed=self._seed
                )
            else:
                train_data, test_data = split_by_loo(
                    filtered, by_time=by_time, seed=self._seed
                )
        elif splitter == "given":
            train_data = read_table(ori_prefix + ".train", sep, columns)
            test_data = read_table(ori_prefix + ".test", sep, columns)
        else:
            raise ValueError("'%s' is an invalid splitter!" % splitter)

        train_data, test_data, self.userids, self.itemids = remap_ids(
            train_data, test_data
        )

        # save cache artifacts, md5 last so a crash never leaves a valid cache
        for sfx, table in ((".train", train_data), (".test", test_data)):
            np.savetxt(
                saved_prefix + sfx,
                np.column_stack([table[c] for c in columns]),
                fmt="%d",
                delimiter=sep,
            )
        user2id = [[user, uid] for user, uid in self.userids.items()]
        item2id = [[item, iid] for item, iid in self.itemids.items()]
        np.savetxt(saved_prefix + ".user2id", user2id, fmt="%s", delimiter=sep)
        np.savetxt(saved_prefix + ".item2id", item2id, fmt="%s", delimiter=sep)

        neg_item_file = ori_prefix + ".neg"
        if os.path.isfile(neg_item_file):
            neg_item_list = []
            for line in read_neg_rows(neg_item_file, sep, self.dataset_name):
                row = [self._remap_token(self.userids, line[0], "user")]
                row.extend(self._remap_token(self.itemids, i, "item") for i in line[1:])
                neg_item_list.append(row)
            test_neg = len(neg_item_list[0]) - 1
            np.savetxt("%s.neg%d" % (saved_prefix, test_neg), neg_item_list, fmt="%d", delimiter=sep)

        with open(saved_prefix + ".md5", "w") as md5_out:
            md5_out.write("\n".join(self._source_md5(splitter, ori_prefix)))

        all_remapped = concat(train_data, test_data)
        self.num_users = int(all_remapped["user"].max()) + 1
        self.num_items = int(all_remapped["item"].max()) + 1
        self.num_ratings = num_rows(all_remapped)

        with open(saved_prefix + ".info", "w") as fout:
            fout.write(os.path.basename(saved_prefix) + "\n" + str(self) + "\n")

        return train_data, test_data

    def _remap_token(self, mapping, tok, which):
        """A ``.neg`` id through an id map: as it is, as text, as an int."""
        if isinstance(tok, float) and np.isnan(tok):
            raise ValueError(
                "ragged line in %s.neg (every row needs the same number of %s ids)" % (self.dataset_name, which))
        if tok in mapping:
            return mapping[tok]
        if str(tok) in mapping:
            return mapping[str(tok)]
        try:
            as_int = int(tok)
        except (TypeError, ValueError):
            as_int = None
        if as_int is not None and as_int in mapping:
            return mapping[as_int]
        raise KeyError("unknown %s id %r in %s.neg" % (which, tok, self.dataset_name))

    def _load_test_neg_items(self, all_data, config, saved_prefix, sep):
        number_neg = config.get("rec.evaluate.neg", 0)
        if not number_neg or number_neg <= 0:
            return None
        neg_items_file = "%s.neg%d" % (saved_prefix, number_neg)
        if not os.path.isfile(neg_items_file):
            rng = np.random.RandomState(self._seed)
            users, items = all_data["user"], all_data["item"]
            order = np.argsort(users, kind="stable")
            users, items = users[order], items[order]
            starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]])
            rows = []
            free = np.ones(self.num_items, dtype=bool)
            for user, u_items in zip(users[starts], np.split(items, starts[1:])):
                # the sorted items the user never rated: np.setdiff1d's result without its sorts
                free[:] = True
                free[u_items] = False
                candidates = np.flatnonzero(free)
                chosen = rng.choice(candidates, size=number_neg, replace=False)
                rows.append([user] + chosen.tolist())
            np.savetxt(neg_items_file, np.asarray(rows), fmt="%d", delimiter=sep)
        else:
            rows = read_neg_rows(neg_items_file, sep, self.dataset_name)
        user_list, item_list = [], []
        for line in rows:
            user_list.extend([line[0]] * (len(line) - 1))
            item_list.extend(line[1:])
        return csr_matrix(
            (np.ones(len(user_list)), (user_list, item_list)), shape=(self.num_users, self.num_items))

    # -- accessors ---------------------------------------------------------
    def get_user_train_dict(self, by_time: bool = False) -> Dict[int, List[int]]:
        if by_time:
            if self.time_matrix is None:
                raise ValueError(
                    "dataset has no time information (column format without T)"
                )
            return csr_to_user_dict_bytime(self.time_matrix, self.train_matrix)
        return csr_to_user_dict(self.train_matrix)

    def get_user_test_dict(self) -> Dict[int, List[int]]:
        return csr_to_user_dict(self.test_matrix)

    def get_user_test_neg_dict(self) -> Optional[Dict[int, List[int]]]:
        if self.negative_matrix is None:
            return None
        return csr_to_user_dict(self.negative_matrix)

    def get_train_interactions(self):
        coo = self.train_matrix.tocoo()
        return coo.row.tolist(), coo.col.tolist()

    def to_csr_matrix(self) -> csr_matrix:
        return self.train_matrix.copy()

    def __str__(self) -> str:
        sparsity = 1 - 1.0 * self.num_ratings / (self.num_users * self.num_items)
        return "\n".join(
            [
                "Dataset name: %s" % self.dataset_name,
                "The number of users: %d" % self.num_users,
                "The number of items: %d" % self.num_items,
                "The number of ratings: %d" % self.num_ratings,
                "Average actions of users: %.2f"
                % (1.0 * self.num_ratings / self.num_users),
                "Average actions of items: %.2f"
                % (1.0 * self.num_ratings / self.num_items),
                "The sparsity of the dataset: %.6f%%" % (sparsity * 100),
            ]
        )

    __repr__ = __str__
