"""FISM — factored item similarity model (Kabbur et al., KDD 2013).

Port of ``neurec_tpu/models/general/fism.py`` (model/general_recommender/
FISM.py:40-180, util/data_generator.py:5-54):

* score(u, i) = n^-alpha * <sum_{j in set} Q'_j, Q_i> + b_i, n = max(|set|, 1);
* a positive i uses the user's set minus i (n = |set|), a negative the
  full set (n = |set| + 1); pairwise or pointwise losses with the
  lambda / gamma split regularization (FISM.py:76-90);
* the user sets are padded sorted rows on the device; "set minus target"
  is sum(all) - Q'(target).

Evaluation is factorized through ``_affine_eval``: the item bias becomes a
column of the item table and a constant-1 column of the user vectors, so
K1 runs at d = ``embedding_size`` + 1 (17 at the conf's 16, its cp.async
path for a ragged d).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss


def padded_rows(dataset, device):
    """The users' padded sorted train rows (pad = num_items) and lengths."""
    padded = build_padded_positives(dataset.train_matrix)
    return (torch.from_numpy(padded.items).long().to(device),
            torch.from_numpy(padded.lengths).to(device))


@register("FISM")
class FISM(Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.alpha = float(config.get("alpha", 0.0))
        self.lambda_bilinear = float(config.get("lambda", config.get("lambda_bilinear", 1e-6)))
        self.gamma_bilinear = float(config.get("gamma", config.get("gamma_bilinear", 1e-6)))
        self.is_pairwise = bool(config.get("is_pairwise", False))
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "pairwise" if self.is_pairwise else "pointwise"
        self._rows, self._lens = padded_rows(dataset, self.device)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {
            "Q_set": init(generator, (self.num_items, self.embedding_size)).to(self.device),
            "Q": init(generator, (self.num_items, self.embedding_size)).to(self.device),
            "bias": torch.zeros((self.num_items,), dtype=torch.float32, device=self.device),
        }

    def _set_sum(self, params, users):
        """Sum of the set embeddings over each user's full padded row, and n."""
        return (torch.sum(self.rows_padded(params, "Q_set", self._rows[users]), dim=1),
                self._lens[users].float())

    def _score(self, params, p, num_idx, items):
        q = self.rows(params, "Q", items)
        coeff = torch.pow(torch.clamp(num_idx, min=1.0), -self.alpha)
        return coeff * torch.sum(p * q, dim=-1) + params["bias"][items], q

    def loss(self, params, batch, weights):
        full_sum, n = self._set_sum(params, batch["users"])
        w = weights[:, None]
        if self.is_pairwise:
            pos = batch["pos_items"]
            p_pos = full_sum - self.rows(params, "Q_set", pos)  # set minus target
            y_pos, q1 = self._score(params, p_pos, n, pos)
            y_neg, q2 = self._score(params, full_sum, n + 1.0, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.lambda_bilinear * l2_loss(p_pos * w) + self.gamma_bilinear * l2_loss(q2 * w, q1 * w))
        items, labels = batch["items"], batch["labels"]
        # positives exclude the target; negatives use the full set
        p = full_sum - self.rows(params, "Q_set", items) * labels[:, None]
        y, q = self._score(params, p, torch.where(labels > 0, n, n + 1.0), items)
        return (pointwise_loss(self.loss_function, labels, y, weights=weights)
                + self.lambda_bilinear * l2_loss(p * w) + self.gamma_bilinear * l2_loss(q * w))

    def _coeff_sum(self, params, users):
        p, n = self._set_sum(params, users)
        return torch.pow(torch.clamp(n, min=1.0), -self.alpha)[:, None], p

    def predict(self, params, users):
        coeff, p = self._coeff_sum(params, users)
        return coeff * (p @ self.whole(params, "Q").T) + params["bias"][None, :]

    def eval_embeddings(self, params, users):
        """Factorized eval form (K1 at d + 1, the bias folded in)."""
        coeff, p = self._coeff_sum(params, users)
        return self._affine_eval(coeff * p, self.whole(params, "Q"), params["bias"])
