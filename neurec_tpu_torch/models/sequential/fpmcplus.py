"""FPMCplus — FPMC with attention over the recent-item window.

Port of ``neurec_tpu/models/sequential/fpmcplus.py`` (model/sequential_
recommender/FPMCplus.py:55-130): the attention MLP
``A(b, h) = softmax_h(h_vec . tanh([UI_u; IL_i; LI_h] W + b))`` over the
``high_order`` recent items, conditioned on the candidate item; score =
<UI_u, IU_i> + <IL_i, sum_h A(b, h) LI_h>. Pairwise or pointwise, reg_mf on
the batch lookups, reg_w on (W, h) (pairwise only, as the reference).

The candidate-conditioned attention makes a full-catalogue ``predict``
O(B I H w); it runs over item chunks of ``_PREDICT_CHUNK`` with the MLP's
input factored as ``[ui W1 + b] + [il W2] + [li W3]``, and ranks on the
predict tier (no factorized form).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.models.sequential.seq_common import SequentialMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss, pairwise_loss, pointwise_loss
from neurec_tpu_torch.parallel.mesh import whole_term

_PREDICT_CHUNK = 1024


@register("FPMCplus")
class FPMCplus(SequentialMixin, Recommender):
    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 16))
        self.weight_size = int(config.get("weight_size", 16))
        self.high_order = int(config.get("high_order", 3))
        self.reg_mf = float(config.get("reg_mf", 1e-5))
        self.reg_w = float(config.get("reg_w", 1e-3))
        self.is_pairwise = bool(config.get("is_pairwise", True))
        self.loss_function = config.get("loss_function", "BPR")
        self.num_negatives = int(config.get("num_neg", config.get("num_negatives", 1)))
        self.embed_init_method = config.get("embed_init_method", "tnormal")
        self.weight_init_method = config.get("weight_init_method", "he_normal")
        self.stddev = float(config.get("stddev", 0.01))
        self.data_kind = "time_pairwise" if self.is_pairwise else "time_pointwise"
        self._setup_recent(dataset)

    def init_params(self, generator: torch.Generator):
        e_init = get_initializer(self.embed_init_method, self.stddev)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        d, w = self.embedding_size, self.weight_size
        params = {
            "UI": e_init(generator, (self.num_users, d)), "IU": e_init(generator, (self.num_items, d)),
            "IL": e_init(generator, (self.num_items, d)), "LI": e_init(generator, (self.num_items, d)),
            "W": w_init(generator, (3 * d, w)), "b": w_init(generator, (1, w)), "h": torch.ones((w, 1)),
        }
        return {k: v.to(self.device) for k, v in params.items()}

    def _attended_recent(self, params, ui, il, li):
        """ui (B, d), il (B, d) on the candidate's side, li (B, H, d) -> (B, d)."""
        x = torch.cat([ui[:, None, :].expand_as(li), il[:, None, :].expand_as(li), li], dim=-1)  # (B, H, 3d)
        mlp = torch.tanh(x @ params["W"] + params["b"])                                       # (B, H, w)
        att = torch.softmax((mlp @ params["h"])[:, :, 0], dim=1)[:, :, None]
        return torch.sum(att * li, dim=1)

    def _score(self, params, users, recent, items):
        ui, iu = self.rows(params, "UI", users), self.rows(params, "IU", items)
        il, li = self.rows(params, "IL", items), self.rows(params, "LI", recent)  # li (B, H, d)
        short = self._attended_recent(params, ui, il, li)
        return torch.sum(ui * iu, dim=-1) + torch.sum(il * short, dim=-1), (ui, iu, il, li)

    def loss(self, params, batch, weights):
        users = batch["users"]
        recent = batch["recent_items"].reshape(-1, self.high_order)
        w, w3 = weights[:, None], weights[:, None, None]
        if self.is_pairwise:
            y_pos, (ui, iu1, il1, li) = self._score(params, users, recent, batch["pos_items"])
            y_neg, (_, iu2, il2, _) = self._score(params, users, recent, batch["neg_items"])
            return (pairwise_loss(self.loss_function, y_pos - y_neg, weights=weights)
                    + self.reg_mf * l2_loss(ui * w, iu1 * w, il1 * w, li * w3, iu2 * w, il2 * w)
                    + whole_term(self.reg_w * l2_loss(params["W"], params["h"])))
        y, (ui, iu, il, li) = self._score(params, users, recent, batch["items"])
        return (pointwise_loss(self.loss_function, batch["labels"], y, weights=weights)
                + self.reg_mf * l2_loss(ui * w, iu * w, il * w, li * w3))

    def predict(self, params, users):
        ui = self.rows(params, "UI", users)                        # (B, d)
        li = self.rows(params, "LI", self._recent_items[users])    # (B, H, d)
        IU, IL = self.whole(params, "IU"), self.whole(params, "IL")
        W1, W2, W3 = torch.split(params["W"], self.embedding_size, dim=0)
        ui_part = ui @ W1 + params["b"]                            # (B, w)
        li_part = li @ W3                                          # (B, H, w)
        out = []
        for sl in chunks(self.num_items, _PREDICT_CHUNK):
            iu_c, il_c = IU[sl], IL[sl]                            # (C, d)
            pre = ui_part[:, None, None, :] + (il_c @ W2)[None, :, None, :] + li_part[:, None, :, :]  # (B, C, H, w)
            att = torch.softmax((torch.tanh(pre) @ params["h"])[..., 0], dim=-1)                   # (B, C, H)
            short = torch.einsum("bch,bhd->bcd", att, li)
            out.append(ui @ iu_c.T + torch.einsum("cd,bcd->bc", il_c, short))
        return torch.cat(out, dim=1)
