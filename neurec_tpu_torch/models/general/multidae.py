"""MultiDAE — denoising autoencoder with a multinomial likelihood.

Port of ``neurec_tpu/models/general/multidae.py`` (model/general_recommender/
MultiDAE.py): l2-normalized dropout input -> dense stack (the activation on
all but the last layer) -> log-softmax; loss = -mean(sum(log_softmax * row))
+ 2 * l2_regularizer(reg)(weights). The last layer is linear over the
items, so the evaluator factors it out (``eval_embeddings``: the last
hidden width plus the bias, K1 at d 33 for p_dim [16, 32]).
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.general.ae_common import DenseRowMixin
from neurec_tpu_torch.ops.activations import activation_function, l2_normalize
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term


@register("MultiDAE")
class MultiDAE(DenseRowMixin, Recommender):
    data_kind = "dense_row"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.act = activation_function(config.get("activation", "tanh"))
        self.reg = float(config.get("reg", 0.0))
        self.weight_init_method = config.get("weight_init_method", "xavier_normal")
        self.bias_init_method = config.get("bias_init_method", "tnormal")
        self.stddev = float(config.get("stddev", 0.01))
        self.keep_prob = float(config.get("keep_prob", 0.8))
        p_dims = list(config.get("p_dim", [16, 32])) + [self.num_items]
        # the encoder mirrors the decoder (MultiDAE.py's dims)
        self.dims = p_dims[::-1] + p_dims[1:]
        self._setup_rows(dataset)

    def init_params(self, generator: torch.Generator):
        w_init = get_initializer(self.weight_init_method, self.stddev)
        b_init = get_initializer(self.bias_init_method, self.stddev)
        params = {"w": [], "b": []}
        for d_in, d_out in zip(self.dims[:-1], self.dims[1:]):
            params["w"].append(w_init(generator, (d_in, d_out)).to(self.device))
            params["b"].append(b_init(generator, (d_out,)).to(self.device))
        return params

    def _forward(self, params, rows, generator=None):
        h = l2_normalize(rows, dim=1)
        if generator is not None:
            h = self._dropout(h, generator, self.keep_prob)
        n = len(params["w"])
        for i, (w, b) in enumerate(zip(params["w"], params["b"])):
            h = h @ w + b
            if i != n - 1:
                h = self.act(h)
        return h

    def loss(self, params, batch, weights):
        params = self.with_whole(params, "w")
        rows = batch["rows"]
        log_softmax = torch.log_softmax(self._forward(params, rows, batch["generator"]), dim=-1)
        denom = torch.clamp(batch_sum(torch.sum(weights)), min=1.0)
        neg_ll = -torch.sum(torch.sum(log_softmax * rows, dim=1) * weights) / denom
        reg_var = whole_term(self.reg * 0.5 * sum(torch.sum(torch.square(w)) for w in params["w"]))
        return neg_ll + 2.0 * reg_var

    def predict(self, params, users):
        return self._forward(self.with_whole(params, "w"), self.make_rows(users))

    def eval_embeddings(self, params, users):
        # the last layer is linear over the items: factor it out
        params = self.with_whole(params, "w")
        h = l2_normalize(self.make_rows(users), dim=1)
        for w, b in zip(params["w"][:-1], params["b"][:-1]):
            h = self.act(h @ w + b)
        return self._affine_eval(h, params["w"][-1].T, params["b"][-1])
