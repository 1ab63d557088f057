"""DAE — denoising autoencoder over dense user rows.

Port of ``neurec_tpu/models/general/dae.py`` (model/general_recommender/
DAE.py): the input row times a Bernoulli(1 - corruption_level) mask, one
hidden layer h = h_act(x W_e + b_e), decoder y = g_act(h W_d + b_d), the
binary cross-entropy summed over every entry + reg * l2(weights, biases)
(DAE.py:52-70). With g_act == sigmoid the cross-entropy is taken from the
logits. A fresh mask each batch, from the step's generator (the reference
draws one an epoch: the same distribution). ``predict`` decodes the whole
catalogue, so the evaluator ranks it on the ``bits`` predict tier (no K1):
its g_act is not linear over the items.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.models.general.ae_common import DenseRowMixin
from neurec_tpu_torch.ops.activations import activation_function
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.parallel.mesh import whole_term


@register("DAE")
class DAE(DenseRowMixin, Recommender):
    data_kind = "dense_row"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.hidden_neuron = int(config.get("hidden_neuron", 100))
        self.h_act_name = config.get("h_act", "sigmoid")
        self.g_act_name = config.get("g_act", "sigmoid")
        self.h_act = activation_function(self.h_act_name)
        self.g_act = activation_function(self.g_act_name)
        self.reg = float(config.get("reg", 0.0))
        self.corruption_level = float(config.get("corruption_level", 0.0))
        self.init_method = config.get("init_method", "normal")
        self.stddev = float(config.get("stddev", 0.01))
        self._setup_rows(dataset)

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        I, h = self.num_items, self.hidden_neuron
        shapes = {"w_enc": (I, h), "b_enc": (h,), "w_dec": (h, I), "b_dec": (I,)}
        return {k: init(generator, s).to(self.device) for k, s in shapes.items()}

    def _decode_logits(self, params, corrupted_rows):
        h = self.h_act(corrupted_rows @ self.whole(params, "w_enc") + params["b_enc"])
        return h @ params["w_dec"] + params["b_dec"]

    def loss(self, params, batch, weights):
        rows = batch["rows"]
        corrupted = rows
        if self.corruption_level > 0:
            corrupted = rows * self._bernoulli(batch["generator"], 1.0 - self.corruption_level, rows.shape).float()
        logits = self._decode_logits(params, corrupted)
        if self.g_act_name == "sigmoid":
            ce = torch.clamp(logits, min=0.0) - logits * rows + F.softplus(-torch.abs(logits))
        else:
            y = torch.clamp(self.g_act(logits), 1e-7, 1 - 1e-7)
            ce = -(rows * torch.log(y) + (1 - rows) * torch.log(1 - y))
        reg = whole_term(self.reg * 0.5 * sum(torch.sum(torch.square(self.whole(params, k)))
                                             for k in ("w_enc", "w_dec", "b_enc", "b_dec")))
        return torch.sum(torch.sum(ce, dim=1) * weights) + reg

    def predict(self, params, users):
        return self.g_act(self._decode_logits(params, self.make_rows(users)))
