"""DMF — deep matrix factorization (Xue et al., IJCAI 2017).

Port of ``neurec_tpu/models/general/dmf.py``, which follows the paper where
the reference class cannot run (DMF.py:117-131 raises before scoring):

* the towers take the user's rating row and the item's rating column, the
  explicit values, as padded (id, value) rows on the device: the first
  layer is a weighted gather-sum, relu, then a dense layer;
* the score is the cosine <u, v> / max(|u| |v|, 1e-12) clipped to
  [1e-6, 1 - 1e-7], the paper's max(mu, y_hat);
* pointwise: the paper's binary cross-entropy on the clipped cosine (mean
  over the weights), or ``loss_function=square``'s sum of squares.

``predict`` recomputes the item tower each call, as the JAX package's
does. Its first layer gathers an (items, L_i, first_layer) transient, L_i
the busiest item's count, so it runs over item chunks of at most
``_TRANSIENT`` elements (the math is row-independent). ``eval_dense_scores``
(all users' scores at once, hoisted out of the eval batches) is offered
only while its (U, I) matrix and user-tower transient fit
``_DENSE_EVAL_BUDGET``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.data.padded import build_padded_positives
from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, chunks, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.parallel.mesh import batch_sum

# elements of one (items, L_i, first_layer) gather in predict: 256 MB of f32
_TRANSIENT = 1 << 26


def _padded_values(matrix, padded) -> np.ndarray:
    """(N, L) float32 rating value for each padded id slot (0.0 on pad)."""
    vals = np.zeros(padded.items.shape, dtype=np.float32)
    indptr, indices, data = matrix.indptr, matrix.indices, matrix.data
    for u in range(matrix.shape[0]):
        lo, hi = indptr[u], indptr[u + 1]
        if hi > lo:
            order = np.argsort(indices[lo:hi])
            vals[u, : hi - lo] = data[lo:hi][order]
    return vals


@register("DMF")
class DMF(Recommender):
    data_kind = "pointwise"

    # all-users predict costs a (U, L_u, f) user-tower transient plus the
    # resident (U, I) matrix: hoisted only while those fit
    _DENSE_EVAL_BUDGET = 512 * 1024 * 1024

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        layers = list(config.get("layers", [200, 100]))
        self.first_layer_size = int(layers[0])
        self.last_layer_size = int(layers[-1])
        self.loss_function = config.get("loss_function", "cross_entropy")
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))

        train = dataset.train_matrix.tocsr()
        user_padded = build_padded_positives(train)
        item_csr = train.T.tocsr()
        item_padded = build_padded_positives(item_csr)

        def put(a, long=False):
            t = torch.from_numpy(a)
            return (t.long() if long else t).to(self.device)

        self._user_rows = put(user_padded.items, long=True)  # (U, Lu) pad = I
        self._item_rows = put(item_padded.items, long=True)  # (I, Li) pad = U
        self._user_vals = put(_padded_values(train, user_padded))
        self._item_vals = put(_padded_values(item_csr, item_padded))
        if not self._dense_eval_fits():
            self.eval_dense_scores = None  # getattr -> absent

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        f, l = self.first_layer_size, self.last_layer_size
        shapes = {"u_w1": (self.num_items, f), "u_b1": (f,), "u_w2": (f, l), "u_b2": (l,),
                  "v_w1": (self.num_users, f), "v_b1": (f,), "v_w2": (f, l), "v_b2": (l,)}
        return {k: init(generator, s).to(self.device) for k, s in shapes.items()}

    def _tower(self, params, side, rows, vals):
        """Rating row @ W1 as a padded weighted gather-sum, relu, dense."""
        w1_rows = self.rows_padded(params, side + "_w1", rows)
        h1 = torch.relu(torch.sum(w1_rows * vals[:, :, None], dim=1) + params[side + "_b1"])
        return h1 @ params[side + "_w2"] + params[side + "_b2"]

    def _user_tower(self, params, users):
        return self._tower(params, "u", self._user_rows[users], self._user_vals[users])

    def _item_tower(self, params, items):
        return self._tower(params, "v", self._item_rows[items], self._item_vals[items])

    @staticmethod
    def _cosine(dot, u_sq, v_sq):
        """Clipped cosine: the paper's y_hat = max(mu, cos) with cos < 1."""
        cos = dot / torch.clamp(torch.sqrt(u_sq * v_sq), min=1e-12)
        return torch.clamp(cos, 1e-6, 1.0 - 1e-7)

    def loss(self, params, batch, weights):
        u = self._user_tower(params, batch["users"])
        v = self._item_tower(params, batch["items"])
        y = self._cosine(torch.sum(u * v, dim=-1), torch.sum(torch.square(u), dim=-1),
                         torch.sum(torch.square(v), dim=-1))
        labels = batch["labels"]
        if self.loss_function.lower() == "square":
            ce = torch.square(labels - y)
            return torch.sum(ce * weights) if weights is not None else torch.sum(ce)
        # paper eq. (12): normalized binary cross-entropy on the cosine
        ce = -(labels * torch.log(y) + (1.0 - labels) * torch.log1p(-y))
        if weights is not None:
            return torch.sum(ce * weights) / torch.clamp(batch_sum(torch.sum(weights)), min=1.0)
        return torch.mean(ce)

    def _dense_eval_fits(self) -> bool:
        trans = self.num_users * int(self._user_rows.shape[1]) * self.first_layer_size
        return 4 * max(trans, self.num_users * self.num_items) <= self._DENSE_EVAL_BUDGET

    def eval_dense_scores(self, params):
        """All users' scores, for the evaluator and serving hoist (present
        only under the budget, see ``__init__``)."""
        return self.predict(params, torch.arange(self.num_users, device=self.device))

    def _item_table(self, params):
        """(I, last_layer) item tower of the whole catalogue, in item chunks."""
        chunk = max(1, _TRANSIENT // (int(self._item_rows.shape[1]) * self.first_layer_size))
        all_items = torch.arange(self.num_items, device=self.device)
        return torch.cat([self._item_tower(params, all_items[sl])
                          for sl in chunks(self.num_items, chunk)], dim=0)

    def predict(self, params, users):
        u = self._user_tower(params, users)  # (B, l)
        v = self._item_table(params)         # (I, l)
        u_sq = torch.sum(torch.square(u), dim=1)[:, None]
        v_sq = torch.sum(torch.square(v), dim=1)[None, :]
        return self._cosine(u @ v.T, u_sq, v_sq)
