"""GRU4RecPlus — GRU4Rec with the bpr-max / top1-max losses and extra
popularity-sampled negatives (Hidasi & Karatzoglou, CIKM 2018).

Port of ``neurec_tpu/models/sequential/gru4recplus.py`` (model/sequential_
recommender/GRU4RecPlus.py:40-175): each step draws ``n_sample`` extra
negatives with probability popularity^sample_alpha, by ``searchsorted`` of
uniform draws (``_uniform``) on the normalized popularity CDF; the losses
weight each negative by a softmax over the batch logits with the diagonal
masked (``_softmax_neg``); bpr-max adds ``bpr_reg`` times the
softmax-weighted squared logits.
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import register
from neurec_tpu_torch.models.sequential.gru4rec import GRU4Rec
from neurec_tpu_torch.parallel.mesh import batch_sum


@register("GRU4RecPlus")
class GRU4RecPlus(GRU4Rec):
    _valid_losses = ("bpr_max", "top1_max")

    def __init__(self, dataset, config, device: DeviceLike = None):
        self.bpr_reg = float(config.get("bpr_reg", 1.0))
        self.n_sample = int(config.get("n_sample", 2048))
        self.sample_alpha = float(config.get("sample_alpha", 0.75))
        super().__init__(dataset, config, device)
        counts = np.asarray((dataset.train_matrix != 0).sum(axis=0)).reshape(-1)
        cumsum = np.cumsum(np.power(np.maximum(counts.astype(np.float64), 0), self.sample_alpha))
        self._pop_cumsum = torch.from_numpy((cumsum / max(cumsum[-1], 1e-12)).astype(np.float32)).to(self.device)

    def _extra_negatives(self, generator):
        idx = torch.searchsorted(self._pop_cumsum, self._uniform(generator, (self.n_sample,)))
        return torch.clamp(idx, max=self.num_items - 1)

    @staticmethod
    def _softmax_neg(logits, valid_cols, B, lo=0):
        """Softmax over each row's valid columns but its own stream's
        (row j is stream lo + j)."""
        eye = torch.eye(logits.shape[1], device=logits.device)[lo:lo + logits.shape[0]]
        hm = (1.0 - eye) * valid_cols[None, :]
        masked = logits * hm
        masked = masked - torch.amax(masked, dim=1, keepdim=True)
        e_x = torch.exp(masked) * hm
        return e_x / torch.clamp(torch.sum(e_x, dim=1, keepdim=True), min=1e-24)

    def _loss_from_logits(self, logits, valid_rows, valid_cols, B, lo=0):
        softmax_scores = self._softmax_neg(logits, valid_cols, B, lo)
        pos = torch.diagonal(logits[:, lo:lo + logits.shape[0]])[:, None]
        if self.loss_name == "bpr_max":
            prob = torch.sum(torch.sigmoid(pos - logits) * softmax_scores, dim=1)
            reg = torch.sum(torch.square(logits) * softmax_scores, dim=1)
            per_row = -torch.log(prob + 1e-24) + self.bpr_reg * reg
        else:  # top1_max
            prob = torch.sigmoid(-pos + logits) + torch.sigmoid(torch.square(logits))
            per_row = torch.sum(prob * softmax_scores, dim=1)
        return torch.sum(per_row * valid_rows) / torch.clamp(batch_sum(torch.sum(valid_rows)), min=1.0)
