"""MultiVAE — variational autoencoder for CF (Liang et al., WWW 2018).

Port of ``neurec_tpu/models/general/multivae.py`` (model/general_recommender/
MultiVAE.py:15-204):

* q-net: l2-normalized dropout input row -> dense stack whose last layer
  emits [mu; logvar];
* z = mu + eps * std with eps ~ N(0, 0.01^2), the reference's small noise;
* p-net -> logits -> log-softmax; neg-ELBO = multinomial NLL + anneal * KL
  + 2 * l2_regularizer(reg)(weights);
* KL annealing: anneal = min(anneal_cap, step / total_anneal_steps), the
  global step from the trainer's dense_row epoch (``batch["step"]``, a 0-d
  device tensor made from the device epoch and cursor), computed on the
  device, so that a graph kept across epochs anneals as the eager steps do.

The dropout mask and eps come from the step's generator. The evaluation
decodes mu; the decoder's last layer is linear over the items, so the
evaluator factors it out (K1 at the last hidden width plus the bias).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.general.ae_common import DenseRowMixin
from neurec_tpu_torch.ops.activations import activation_function, l2_normalize
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term


@register("MultiVAE")
class MultiVAE(DenseRowMixin, Recommender):
    data_kind = "dense_row"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.act = activation_function(config.get("activation", "tanh"))
        self.reg = float(config.get("reg", 0.0))
        self.anneal_cap = float(config.get("anneal_cap", 0.2))
        self.total_anneal_steps = int(config.get("total_anneal_steps", 2000))
        self.weight_init_method = config.get("weight_init_method", "xavier_normal")
        self.bias_init_method = config.get("bias_init_method", "tnormal")
        self.stddev = float(config.get("stddev", 0.01))
        self.keep_prob = float(config.get("keep_prob", 0.8))
        self.p_dims = list(config.get("p_dim", [16, 32])) + [self.num_items]
        self.q_dims = self.p_dims[::-1]
        self._setup_rows(dataset)

    def init_params(self, generator: torch.Generator):
        w_init = get_initializer(self.weight_init_method, self.stddev)
        b_init = get_initializer(self.bias_init_method, self.stddev)
        params = {"q_w": [], "q_b": [], "p_w": [], "p_b": []}
        for i, (d_in, d_out) in enumerate(zip(self.q_dims[:-1], self.q_dims[1:])):
            if i == len(self.q_dims) - 2:
                d_out *= 2  # [mu; logvar]
            params["q_w"].append(w_init(generator, (d_in, d_out)).to(self.device))
            params["q_b"].append(b_init(generator, (d_out,)).to(self.device))
        for d_in, d_out in zip(self.p_dims[:-1], self.p_dims[1:]):
            params["p_w"].append(w_init(generator, (d_in, d_out)).to(self.device))
            params["p_b"].append(b_init(generator, (d_out,)).to(self.device))
        return params

    def _q_net(self, params, rows, generator=None):
        h = l2_normalize(rows, dim=1)
        if generator is not None:
            h = self._dropout(h, generator, self.keep_prob)
        n = len(params["q_w"])
        for i, (w, b) in enumerate(zip(params["q_w"], params["q_b"])):
            h = h @ w + b
            if i != n - 1:
                h = self.act(h)
        d = self.q_dims[-1]
        return h[:, :d], h[:, d:]

    def _p_net(self, params, z):
        n = len(params["p_w"])
        h = z
        for i, (w, b) in enumerate(zip(params["p_w"], params["p_b"])):
            h = h @ w + b
            if i != n - 1:
                h = self.act(h)
        return h

    def loss(self, params, batch, weights):
        params = self.with_whole(params, "q_w", "p_w")
        rows, generator = batch["rows"], batch["generator"]
        mu, logvar = self._q_net(params, rows, generator)
        std = torch.exp(0.5 * logvar)
        z = mu + 0.01 * self._normal(generator, std.shape) * std
        log_softmax = torch.log_softmax(self._p_net(params, z), dim=-1)

        denom = torch.clamp(batch_sum(torch.sum(weights)), min=1.0)
        neg_ll = -torch.sum(torch.sum(log_softmax * rows, dim=1) * weights) / denom
        kl_per_user = torch.sum(0.5 * (-logvar + torch.exp(logvar) + torch.square(mu) - 1.0), dim=1)
        kl = torch.sum(kl_per_user * weights) / denom
        if self.total_anneal_steps > 0:
            # min(cap, step / total) on the device in f64, then f32: the
            # bits of the Python float times an f32 tensor
            step = torch.as_tensor(batch["step"], device=rows.device).double()
            anneal = torch.clamp(step / self.total_anneal_steps, max=self.anneal_cap).float()
        else:
            anneal = self.anneal_cap
        reg_var = whole_term(self.reg * 0.5 * sum(torch.sum(torch.square(p)) for p in params["q_w"] + params["p_w"]))
        return neg_ll + anneal * kl + 2.0 * reg_var

    def predict(self, params, users):
        params = self.with_whole(params, "q_w", "p_w")
        mu, _ = self._q_net(params, self.make_rows(users))
        return self._p_net(params, mu)

    def eval_embeddings(self, params, users):
        # the decoder's last layer is linear over the items: factor it out
        params = self.with_whole(params, "q_w", "p_w")
        h, _ = self._q_net(params, self.make_rows(users))
        for w, b in zip(params["p_w"][:-1], params["p_b"][:-1]):
            h = self.act(h @ w + b)
        return self._affine_eval(h, params["p_w"][-1].T, params["p_b"][-1])
