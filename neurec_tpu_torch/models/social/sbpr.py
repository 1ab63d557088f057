"""SBPR — social Bayesian personalized ranking (Zhao et al., CIKM 2014).

Port of ``neurec_tpu/models/social/sbpr.py`` (model/social_recommender/
SBPR.py:30-166):

* a user's social items are the items their friends rated and they did
  not, in first-seen order: friend by friend in the social matrix's column
  order, each friend's items in ``get_user_train_dict`` order; each weighs
  suk = 1 + the friends who rated it. Users without a social item are
  skipped;
* per positive: one social item drawn uniformly from the user's set, and one
  negative excluded from the positives AND the social items;
* loss = bpr((y_pos - y_soc) / suk) + bpr(y_soc - y_neg) + reg_mf *
  l2(w-weighted lookups and the three biases);
* the reference's quirk kept: the evaluation scores u @ item_emb^T WITHOUT
  the trained item bias (SBPR.py:152-160), K1 at ``embedding_size``.

The host tables are the JAX model's, bit for bit: ``_users_flat``,
``_pos_flat``, ``_social_items`` (U, max_s), ``_social_suk`` (U, max_s),
``_social_len`` (U,), 1 for a user without social items, and ``_excl_rows``
(U, L_max + max_s), each user's positives and social items sorted, padded
with ``num_items``. They are built vectorised (``social_tables``) in the
same order as the JAX model's loops. As in the JAX package they do not go
through the Trainer's exclusion-table budget: ``table_bytes`` says what
they hold.

A custom epoch: ``_perm`` and a seed a step, then each step
``_social_slot`` (the raw ``randint(0, 2**30)`` that the model reduces
modulo the user's social count) and ``_negatives`` from the step's own
generator; on a CUDA device the steps are CUDA-graph replays
(``epoch_steps``, ``step_graph.py``). On a mesh each step is split over 'data' as the
JAX package's (``sbpr.py:116,118``): the draws made for the whole batch,
then this rank's rows of the slots, weights, social slots and negatives.
Every term of the loss is a sum over the batch's rows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from scipy.sparse import csr_matrix

from neurec_tpu_torch.data.social import load_social_matrix
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss
from neurec_tpu_torch.ops.sampling import sample_negatives
from neurec_tpu_torch.step_graph import Steps, at, step_seeds, train_step


class SocialTables(NamedTuple):
    users_flat: np.ndarray  # (N,) int32
    pos_flat: np.ndarray    # (N,) int32
    items: np.ndarray       # (U, max_s) int32, 0-padded
    suk: np.ndarray         # (U, max_s) float32, 1-padded
    lengths: np.ndarray     # (U,) int32, 1 where a user has no social item
    excl: np.ndarray        # (U, L_max + max_s) int32, sorted, padded with num_items


def _expand_rows(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The CSR positions of ``rows``' entries, row after row, each row's
    entries in stored order."""
    lens = indptr[rows + 1] - indptr[rows]
    total = int(lens.sum())
    starts = np.repeat(indptr[rows] - (np.cumsum(lens) - lens), lens)
    return starts + np.arange(total, dtype=np.int64)


def _rank_in_runs(keys_row: np.ndarray) -> np.ndarray:
    """Position of each entry inside its run of equal (sorted) row ids."""
    n = len(keys_row)
    change = np.ones(n, dtype=bool)
    change[1:] = keys_row[1:] != keys_row[:-1]
    starts = np.flatnonzero(change)
    return np.arange(n) - np.repeat(starts, np.diff(np.append(starts, n)))


def social_tables(train: csr_matrix, social: csr_matrix) -> SocialTables:
    """The JAX model's six host tables (neurec_tpu/models/social/sbpr.py:45-86)."""
    U, I = train.shape
    t_ptr, t_idx = train.indptr.astype(np.int64), train.indices.astype(np.int64)
    t_len = np.diff(t_ptr)
    s_ptr = social.indptr.astype(np.int64)
    # (user, friend) edges in the CSR's row-major order, users with train items only
    eu = np.repeat(np.arange(U, dtype=np.int64), np.diff(s_ptr))
    ef = social.indices.astype(np.int64)
    keep = t_len[eu] > 0
    eu, ef = eu[keep], ef[keep]
    # every (user, friend's item) pair in visiting order
    pair_u = np.repeat(eu, t_len[ef])
    pair_i = t_idx[_expand_rows(t_ptr, ef)]
    key = pair_u * I + pair_i
    own = np.sort(np.repeat(np.arange(U, dtype=np.int64), t_len) * I + t_idx)
    at = np.minimum(np.searchsorted(own, key), max(len(own) - 1, 0))
    is_own = own[at] == key if len(own) else np.zeros(len(key), dtype=bool)
    key = key[~is_own]
    # first-seen order: the pairs run user by user, so sorting the distinct
    # pairs by their first position orders them by user, then first sight
    uniq, first, counts = np.unique(key, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    s_key, s_cnt = uniq[order], counts[order]
    s_u, s_i = s_key // I, s_key % I
    lengths = np.bincount(s_u, minlength=U).astype(np.int64)
    max_s = int(lengths.max()) if len(s_u) else 1
    items = np.zeros((U, max_s), dtype=np.int32)
    suk = np.ones((U, max_s), dtype=np.float32)
    rank = _rank_in_runs(s_u)
    items[s_u, rank] = s_i
    suk[s_u, rank] = s_cnt + 1
    soc_len = np.where(lengths > 0, lengths, 1).astype(np.int32)
    # the positives of the users with social items, user by user
    with_social = np.flatnonzero(lengths > 0)
    users_flat = np.repeat(with_social, t_len[with_social]).astype(np.int32)
    pos_flat = t_idx[_expand_rows(t_ptr, with_social)].astype(np.int32)
    # exclusion rows: positives and social items, sorted, padded with num_items
    l_max = max(int(t_len.max()) if U else 0, 8)
    width = l_max + (-l_max) % 8 + max_s
    excl = np.full((U, width), I, dtype=np.int32)
    both = np.unique(np.concatenate([own, s_key]))
    excl[both // I, _rank_in_runs(both // I)] = both % I
    return SocialTables(users_flat, pos_flat, items, suk, soc_len, excl)


@register("SBPR")
class SBPR(Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.reg_mf = float(config.get("reg_mf", 0.01))
        self.loss_function = config.get("loss_function", "bpr")
        self.epochs = int(config.get("num_epochs", config.get("epochs", 500)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))

        self.social_matrix = load_social_matrix(dataset, config)
        tables = social_tables(dataset.train_matrix, self.social_matrix)
        self.max_s = int(tables.items.shape[1])

        def put(a):
            return torch.from_numpy(a).to(self.device)

        self._users_flat = put(tables.users_flat).long()
        self._pos_flat = put(tables.pos_flat).long()
        self._social_items = put(tables.items)
        self._social_suk = put(tables.suk)
        self._social_len = put(tables.lengths).long()
        self._excl_rows = put(tables.excl)

    @property
    def table_bytes(self) -> Dict[str, int]:
        """Bytes of the padded device tables (soc, suk: (U, max_s); excl:
        (U, L_max + max_s)), which no budget bounds."""
        return {"soc": self._social_items.nbytes, "suk": self._social_suk.nbytes,
                "excl": self._excl_rows.nbytes}

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {
            "user_emb": init(generator, (self.num_users, self.embedding_size)).to(self.device),
            "item_emb": init(generator, (self.num_items, self.embedding_size)).to(self.device),
            "bias": init(generator, (self.num_items,)).to(self.device),
        }

    # -- draws ----------------------------------------------------------------
    @staticmethod
    def _perm(generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=generator, device=generator.device)

    @staticmethod
    def _social_slot(generator: torch.Generator, n: int) -> torch.Tensor:
        """(n,) int64 uniform in [0, 2**30): the raw draw the model reduces
        modulo each user's social count (``jax.random.randint``)."""
        return torch.randint(0, 2 ** 30, (n,), generator=generator, device=generator.device)

    def _negatives(self, generator: torch.Generator, rows: torch.Tensor) -> torch.Tensor:
        return sample_negatives(generator, rows, self.num_items, ()).long()

    # -- loss and epoch -------------------------------------------------------
    def sbpr_loss(self, params, users, pos, soc, suk, negs, w):
        def score(items):
            q, b = self.rows(params, "item_emb", items), params["bias"][items]
            return torch.sum(self.rows(params, "user_emb", users) * q, dim=-1) + b, q, b

        y_pos, q1, b1 = score(pos)
        y_soc, q2, b2 = score(soc)
        y_neg, q3, b3 = score(negs)
        u = self.rows(params, "user_emb", users)
        w2 = w[:, None]
        return (
            pairwise_loss(self.loss_function, (y_pos - y_soc) / suk, weights=w)
            + pairwise_loss(self.loss_function, y_soc - y_neg, weights=w)
            + self.reg_mf * l2_loss(u * w2, q2 * w2, q1 * w2, q3 * w2, b1 * w, b2 * w, b3 * w)
        )

    def epoch_steps(self, params, opt, generator, max_steps=None, trainer=None) -> Steps:
        """One epoch's steps over the positives of the users with social
        items (``step_graph.Steps``): the permutation and a seed a step
        drawn from ``generator`` here; a step reads its slots at the cursor
        and draws its social slots and negatives from its own generator.
        ``max_steps`` cuts it. With a ``trainer`` on a mesh each step is
        split over 'data' (``Trainer.dp_split_for``)."""
        B = self.batch_size
        N = int(self._users_flat.shape[0])
        steps = -(-N // B)
        perm = self._perm(generator, steps * B)
        idx = torch.where(perm < N, perm, torch.zeros_like(perm)).reshape(steps, B)
        w = (perm < N).float().reshape(steps, B)
        n_run = steps if max_steps is None else min(steps, max_steps)
        seeds = step_seeds(generator, steps)[:n_run]
        split = None if trainer is None else trainer.dp_split_for(B)

        def make(cursor, total, idx, w):
            def step(gen):
                idx_s, w_s = at(cursor, idx, w)
                users = self._users_flat[idx_s]
                slot = self._social_slot(gen, B) % self._social_len[users]
                negs = self._negatives(gen, self._excl_rows[users])
                if split is not None:  # this rank's rows of the step
                    idx_s, w_s, slot, negs = trainer.dp_constrain(idx_s, w_s, slot, negs)
                    users = self._users_flat[idx_s]
                pos = self._pos_flat[idx_s]
                soc = self._social_items[users, slot].long()
                suk = self._social_suk[users, slot]
                train_step(lambda: self.sbpr_loss(params, users, pos, soc, suk, negs, w_s), opt, cursor, total,
                                trainer, split, params)
            return step

        return Steps(make, n_run, seeds, opt, split, inputs=dict(idx=idx, w=w), reads=params)

    def run_epoch(self, params, opt, generator, max_steps=None, trainer=None):
        """One epoch (``epoch_steps``): ``(params, opt, mean step loss)``;
        its steps CUDA-graph replays where the trainer captures."""
        steps = self.epoch_steps(params, opt, generator, max_steps, trainer)
        return params, opt, self.take_steps(trainer, steps) / max(steps.n, 1)

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            return self.run_epoch(params, opt_state, generator, max_steps, trainer=trainer)

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("SBPR uses build_epoch (data_kind='custom')")

    def predict(self, params, users):
        # no item bias at evaluation: the reference's quirk (module docstring)
        return self.rows(params, "user_emb", users) @ self.whole(params, "item_emb").T

    def eval_embeddings(self, params, users):
        return self.rows(params, "user_emb", users), self.whole(params, "item_emb")
