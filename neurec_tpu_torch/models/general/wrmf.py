"""WRMF — weighted regularized MF by implicit-feedback ALS (Hu et al., ICDM 2008).

Port of ``neurec_tpu/models/general/wrmf.py`` (model/general_recommender/
WRMF.py:25-106): confidence C = alpha and preference P = 1 on the observed
entries; each epoch solves both sides in closed form,

    x_u = (Y^T Y + alpha Y_u^T Y_u + reg I)^-1 (alpha + 1) Y_u^T 1
    y_i = (X^T X + alpha X_i^T X_i + reg I)^-1 (alpha + 1) X_i^T 1

with Y_u the item factors of u's positives (C is alpha only there). All
users, then all items, are one batched (d, d) ``torch.linalg.solve`` over
the padded positive rows (pads gather a zero row), in row chunks that
bound the (rows, L, d) gather; the JAX package solves the same way,
outside any Pallas kernel. No gradient: ``make_optimizer`` is the identity
(no optimizer state). The epoch's "loss" is the squared preference error
on the positives. Evaluated through K1 at d = embedding_size.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.ops.initializers import get_initializer

# elements of one (rows, L, d) gather of a solve or of the loss: 256 MB of f32
_TRANSIENT = 1 << 26


@register("WRMF")
class WRMF(Recommender):
    data_kind = "custom"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.alpha = float(config.get("alpha", 1.0))
        self.reg_mf = float(config.get("reg_mf", 0.01))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        user_padded = build_padded_positives(dataset.train_matrix)
        item_padded = build_padded_positives(dataset.train_matrix.T.tocsr())
        self._user_rows = torch.from_numpy(user_padded.items).long().to(self.device)  # (U, Lu), pad = I
        self._item_rows = torch.from_numpy(item_padded.items).long().to(self.device)  # (I, Li), pad = U

    def make_optimizer(self):
        return lambda params: None  # the identity: ALS takes no gradient step

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {"user_emb": init(generator, (self.num_users, self.embedding_size)).to(self.device),
                "item_emb": init(generator, (self.num_items, self.embedding_size)).to(self.device)}

    def _row_chunks(self, rows: torch.Tensor):
        return chunks(rows.shape[0], max(1, _TRANSIENT // (rows.shape[1] * self.embedding_size)))

    def _solve_side(self, other_emb: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Every row of one side given the other side's factors; ``rows``
        (N, L) index ``other_emb`` (pad == len(other_emb))."""
        d = self.embedding_size
        table = torch.cat([other_emb, other_emb.new_zeros((1, d))], dim=0)
        gtg = other_emb.T @ other_emb + self.reg_mf * torch.eye(d, device=other_emb.device)
        out = []
        for sl in self._row_chunks(rows):
            y = table[rows[sl]]                                   # (n, L, d), zero pads
            a = gtg + self.alpha * (y.transpose(1, 2) @ y)
            b = (self.alpha + 1.0) * torch.sum(y, dim=1)
            out.append(torch.linalg.solve(a, b))
        return torch.cat(out, dim=0)

    def _loss(self, user_emb, item_emb) -> torch.Tensor:
        """sum((1 - <x_u, y_i>)^2) / count over the positives."""
        table = torch.cat([item_emb, item_emb.new_zeros((1, self.embedding_size))], dim=0)
        total = torch.zeros((), device=user_emb.device)
        for sl in self._row_chunks(self._user_rows):
            rows = self._user_rows[sl]
            pred = torch.einsum("ud,uld->ul", user_emb[sl], table[rows])
            total = total + torch.sum(torch.square((1.0 - pred) * (rows < self.num_items).float()))
        return total / max(float((self._user_rows < self.num_items).sum()), 1.0)

    def _solve_split(self, trainer, other_emb: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``_solve_side`` over the mesh's 'data' axis (``wrmf.py:79-82``):
        each rank solves its rows (``Trainer.dp_constrain``) and the solved
        rows are all-gathered, not summed; rows that do not divide the axis
        are solved whole on every rank."""
        split = trainer.dp_split_for(rows.shape[0])
        if split is None:
            return self._solve_side(other_emb, rows)
        return trainer.dp_gather(self._solve_side(other_emb, trainer.dp_constrain(rows)), split)

    def build_epoch(self, trainer):
        def epoch(params, opt_state, generator, epoch, max_steps=None):
            del generator, epoch, max_steps  # ALS draws nothing and has no steps
            with torch.no_grad():
                user_emb = self._solve_split(trainer, self.whole(params, "item_emb"), self._user_rows)
                item_emb = self._solve_split(trainer, user_emb, self._item_rows)
                loss = self._loss(user_emb, item_emb)
            # the solved tables are whole on every rank: each keeps its block
            solved = {"user_emb": self.own_block("user_emb", user_emb),
                      "item_emb": self.own_block("item_emb", item_emb)}
            return solved, opt_state, loss

        return epoch

    def loss(self, params, batch, weights):
        raise RuntimeError("WRMF uses closed-form ALS (data_kind='custom')")

    def predict(self, params, users):
        return self.rows(params, "user_emb", users) @ self.whole(params, "item_emb").T

    def eval_embeddings(self, params, users):
        return self.rows(params, "user_emb", users), self.whole(params, "item_emb")
