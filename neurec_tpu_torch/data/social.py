"""Social graph loading (port of ``neurec_tpu/data/social.py``; the
reference's SocialAbstractRecommender, model/AbstractRecommender.py:55-73).

Reads a headerless (user, friend) edge file with the dataset's separator
(the port's numpy reader, ``data/preprocess.py::read_table``), keeps the
edges whose two ends are keys of ``dataset.userids`` (int keys for numeric
ids, str otherwise, as the dataset's maps hold them), and returns a
(num_users, num_users) float64 CSR matrix of the remapped ids. As in the
JAX package: an edge listed twice sums to 2, a self-loop is kept, and an
edge written both ways gives two entries.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from neurec_tpu_torch.data.preprocess import read_table


def load_social_matrix(dataset, config) -> sp.csr_matrix:
    edges = read_table(config["social_file"], config["data.convert.separator"], ["user", "friend"])
    ids = dataset.userids
    user_id = [ids.get(u, -1) for u in edges["user"].tolist()]
    friend_id = [ids.get(f, -1) for f in edges["friend"].tolist()]
    keep = [u >= 0 and f >= 0 for u, f in zip(user_id, friend_id)]
    user_id = np.asarray(user_id, dtype=np.int64)[np.asarray(keep, dtype=bool)]
    friend_id = np.asarray(friend_id, dtype=np.int64)[np.asarray(keep, dtype=bool)]
    num_users = dataset.num_users
    return sp.csr_matrix((np.ones(len(user_id)), (user_id, friend_id)), shape=(num_users, num_users))
