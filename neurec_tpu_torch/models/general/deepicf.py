"""DeepICF — deep item-based CF (Xue et al., IJCAI 2018): NAIS attention and
a deep MLP over the attended interaction vector.

Port of ``neurec_tpu/models/general/deepicf.py`` (model/general_recommender/
DeepICF.py:100-175):

* the attended p (NAIS attention, beta-smoothed), scaled by n^alpha;
* a deep tower over p * q_i: dense + optional batch norm + relu per layer,
  a scalar output + the item bias, sigmoid -> probability;
* loss = log loss (mean over the weights) + lambda * l2(Q) + gamma *
  l2(Q_set) + eta * l2(W), over the FULL tables (DeepICF.py:172-175);
* pointwise FISM feeds only; a FISM ``pretrain_file`` warm-starts Q_set, Q
  and bias (NAIS's path; the reference's broken two-pickle leg is not kept).

Mirrored deviation: batch norm uses the statistics of the call (the
reference keeps moving averages for inference): over the batch in
``loss``, and over one user's whole catalogue in ``predict``, as the JAX
package's ``lax.map`` sees one user's (I, d) at a time. ``predict`` takes
NAIS's attention over the batch's train edges into a (B, I, d) input and
runs the tower over static groups of users (``_TOWER`` elements of its
widest layer at most), its statistics over the item axis alone.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.models.base import chunks, register
from neurec_tpu_torch.models.general.nais import NAIS
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term


# elements of one (users, items, layer) tower transient in predict: 256 MB of f32
_TOWER = 1 << 26


@register("DeepICF")
class DeepICF(NAIS):
    def __init__(self, dataset, config, device=None):
        super().__init__(dataset, config, device)
        self.n_hidden = list(config.get("layers", [64, 32, 16]))
        self.use_batch_norm = bool(config.get("batch_norm", False))
        # batch norm's statistics are the whole batch's, and a split step
        # cannot keep the single step's numbers: the batch mean removes the
        # layers' biases, whose gradient is then f32 noise that Adam turns
        # into steps of lr, and the first layer centres activations whose
        # mean (the bias) is hundreds of times their spread, so a split's
        # other rounding (statistics over the gathered rows) moved the
        # weights by 7.9e-5 in 5 Adam steps at the conf's widths on gowalla
        # (an H100), past the split's 1e-5 bound. It runs whole on every rank
        self.dp_split = not self.use_batch_norm
        self.is_pairwise = False
        self.data_kind = "pointwise"

    def init_params(self, generator: torch.Generator):
        params = super().init_params(generator)
        w_init = get_initializer(self.weight_init_method, self.stddev)
        normal = get_initializer("normal", 1.0)
        dims = [self.embedding_size] + self.n_hidden
        params["deep_w"], params["deep_b"], params["bn"] = [], [], []
        for i, n in enumerate(self.n_hidden):
            params["deep_w"].append(w_init(generator, (dims[i], dims[i + 1])).to(self.device))
            params["deep_b"].append(normal(generator, (n,)).to(self.device))
            params["bn"].append({"gamma": torch.ones((n,), device=self.device),
                                 "beta": torch.zeros((n,), device=self.device)})
        params["out_w"] = w_init(generator, (self.n_hidden[-1], 1)).to(self.device)
        params["out_b"] = normal(generator, (1,)).to(self.device)
        return params

    def _tower(self, params, x):
        """x (..., d) -> (...,) through dense + batch norm + relu layers."""
        for i in range(len(self.n_hidden)):
            x = x @ params["deep_w"][i] + params["deep_b"][i]
            if self.use_batch_norm:
                axes = tuple(range(x.ndim - 1))
                mean = torch.mean(x, dim=axes, keepdim=True)
                var = torch.var(x, dim=axes, keepdim=True, correction=0)
                x = params["bn"][i]["gamma"] * (x - mean) * torch.rsqrt(var + 1e-3) + params["bn"][i]["beta"]
            x = torch.relu(x)
        return (x @ params["out_w"] + params["out_b"])[..., 0]

    def _prob(self, params, p_scaled, q, items):
        return torch.sigmoid(self._tower(params, p_scaled * q) + params["bias"][items])

    def _catalogue_tower(self, params, x):
        """x (g, I, d) -> (g, I): ``_tower`` with each user's batch norm over
        its catalogue (axis 1), in fewer passes over the (g, I, h)
        activations: the bias in the product (``addmm``), the statistics
        in one (``var_mean``), the normalization as ``x - mean`` then one
        ``addcmul`` by gamma / sqrt(var + eps)."""
        g, n = x.shape[:2]
        for i in range(len(self.n_hidden)):
            x = torch.addmm(params["deep_b"][i], x.reshape(g * n, -1), params["deep_w"][i]).view(g, n, -1)
            if self.use_batch_norm:
                var, mean = torch.var_mean(x, dim=1, keepdim=True, correction=0)
                scale = params["bn"][i]["gamma"] * torch.rsqrt(var + 1e-3)
                x = torch.addcmul(params["bn"][i]["beta"], x - mean, scale)
            x = torch.relu_(x)
        return torch.addmm(params["out_b"], x.view(g * n, -1), params["out_w"]).view(g, n)

    def loss(self, params, batch, weights):
        items, labels = batch["items"], batch["labels"]
        p, n, _, q = self._attended(params, batch["users"], items, labels)
        coeff = torch.pow(torch.clamp(torch.where(labels > 0, n, n + 1.0), min=1.0), self.alpha)[:, None]
        prob = torch.clamp(self._prob(params, coeff * p, q, items), 1e-7, 1 - 1e-7)
        ce = -(labels * torch.log(prob) + (1 - labels) * torch.log(1 - prob))
        denom = torch.clamp(batch_sum(torch.sum(weights)), min=1.0)
        return torch.sum(ce * weights) / denom + whole_term(
            self.lambda_bilinear * l2_loss(self.whole(params, "Q"))
            + self.gamma_bilinear * l2_loss(self.whole(params, "Q_set"))
            + self.eta_bilinear * l2_loss(params["W"]))

    def predict(self, params, users, capacity=None):
        """(B, I) probabilities of ``users`` over ``capacity`` edge slots
        (NAIS's ``predict``); the tower's batch norm reduces over each
        user's catalogue only."""
        coeff = self._coeff(users)[:, :, None]
        x = coeff.new_empty((users.shape[0], self.num_items, self.embedding_size))
        for sl, p, q in self._attend_edges(params, users, self._capacity(users, capacity)):
            x[:, sl] = coeff * p * q
        g = max(1, _TOWER // (self.num_items * max(self.n_hidden + [self.embedding_size])))
        return torch.cat([torch.sigmoid(self._catalogue_tower(params, x[sl]) + params["bias"])
                          for sl in chunks(users.shape[0], g)], dim=0)
