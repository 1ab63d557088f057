"""CDAE — collaborative denoising autoencoder (Wu et al., WSDM 2016).

Port of ``neurec_tpu/models/general/cdae.py`` (model/general_recommender/
CDAE.py):

* encoder: hidden = act(dropout(row) E_enc + u_emb + offset); the row
  dropout keeps zeros at zero and scales kept entries by 1 / keep;
* ``num_neg`` negatives per positive slot (``L * num_neg`` a row, drawn in
  the loss from the exclusion sampler, ``ops/sampling.py``) are added to the
  input row as pseudo-positives (CDAE.py:115);
* the loss covers the user's positives and the sampled negatives only:
  square or sigmoid cross-entropy, summed, + reg * l2(looked-up params);
* eval: hidden E_dec^T + bias, factorized for the evaluator (K1 at
  hidden_dim + 1).

The JAX package's documented deviations are kept: negatives drawn with
replacement and not made unique, repeated items counted once per
occurrence in the L2 term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.general.ae_common import DenseRowMixin
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.sampling import sample_negatives
from neurec_tpu_torch.parallel.mesh import whole_term


@register("CDAE")
class CDAE(DenseRowMixin, Recommender):
    data_kind = "dense_row"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.emb_size = int(config.get("hidden_dim", 64))
        self.learning_rate = float(config.get("lr", config.get("learning_rate", 0.001)))
        self.reg = float(config.get("reg", 0.001))
        self.dropout = float(config.get("dropout", 0.5))
        self.num_neg = int(config.get("num_neg", 5))
        self.loss_func = config.get("loss_func", "sigmoid_cross_entropy")
        hidden_act = config.get("hidden_act", "sigmoid")
        if hidden_act == "identity":
            self.hidden_act = lambda x: x
        elif hidden_act == "sigmoid":
            self.hidden_act = torch.sigmoid
        else:
            raise ValueError("hidden activate function %s is invalid." % hidden_act)
        if self.loss_func not in ("square", "sigmoid_cross_entropy"):
            raise ValueError("%s is an invalid loss function." % self.loss_func)
        self._setup_rows(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer("tnormal", 0.01)
        d = self.emb_size
        params = {
            "user_emb": init(generator, (self.num_users, d)),
            "en_emb": init(generator, (self.num_items, d)),
            "en_offset": torch.zeros((d,)),
            "de_emb": init(generator, (self.num_items, d)),
            "de_bias": torch.zeros((self.num_items,)),
        }
        return {k: v.to(self.device) for k, v in params.items()}

    def _negatives(self, generator, pos_rows, n):
        """(B, n) negatives of each row, excluding its positives."""
        return sample_negatives(generator, pos_rows, self.num_items, (n,)).long()

    def _encode(self, params, users, rows, generator=None):
        if generator is not None and self.dropout > 0:
            rows = self._dropout(rows, generator, 1.0 - self.dropout)
        return self.hidden_act(rows @ self.whole(params, "en_emb") + self.rows(params, "user_emb", users)
                               + params["en_offset"])

    def loss(self, params, batch, weights):
        users, generator = batch["users"], batch["generator"]
        I, B = self.num_items, users.shape[0]
        pos_rows = self._padded_items[users]                  # (B, L), pad = I
        L = pos_rows.shape[1]
        slot_valid = pos_rows < I
        negs = self._negatives(generator, pos_rows, L * self.num_neg)
        # the input row: positives and the sampled negatives marked 1
        neg_slot_valid = torch.repeat_interleave(slot_valid, self.num_neg, dim=1)
        ext = torch.zeros((B, I + 1), dtype=torch.float32, device=users.device)
        ext.scatter_(1, pos_rows, 1.0)
        ext.scatter_(1, torch.where(neg_slot_valid, negs, I), 1.0)
        hidden = self._encode(params, users, ext[:, :I], generator)  # (B, d)

        items = torch.cat([torch.clamp(pos_rows, max=I - 1), negs], dim=1)  # (B, L (1 + num_neg))
        labels = torch.cat([torch.ones((B, L), device=users.device),
                            torch.zeros((B, L * self.num_neg), device=users.device)], dim=1)
        entry_w = torch.cat([slot_valid, neg_slot_valid], dim=1).float() * weights[:, None]
        de_rows = self.rows(params, "de_emb", items)
        ratings = torch.einsum("bd,bed->be", hidden, de_rows) + params["de_bias"][items]
        if self.loss_func == "square":
            model_loss = torch.square(ratings - labels)
        else:
            model_loss = torch.clamp(ratings, min=0.0) - ratings * labels + F.softplus(-torch.abs(ratings))
        w2 = entry_w[:, :, None]
        reg_loss = 0.5 * (
            torch.sum(torch.square(self.rows(params, "en_emb", items) * w2))
            + torch.sum(torch.square(de_rows * w2))
            + torch.sum(torch.square(params["de_bias"][items] * entry_w))
            + torch.sum(torch.square(self.rows(params, "user_emb", users) * weights[:, None]))
        ) + whole_term(0.5 * torch.sum(torch.square(params["en_offset"])))
        return torch.sum(model_loss * entry_w) + self.reg * reg_loss

    def predict(self, params, users):
        hidden = self._encode(params, users, self.make_rows(users))
        return hidden @ self.whole(params, "de_emb").T + params["de_bias"]

    def eval_embeddings(self, params, users):
        hidden = self._encode(params, users, self.make_rows(users))
        return self._affine_eval(hidden, self.whole(params, "de_emb"), params["de_bias"])
