"""APR / AMF — adversarial personalized ranking (He et al., SIGIR 2018).

Port of ``neurec_tpu/models/general/apr.py`` (model/general_recommender/
APR.py:40-125): BPR-MF whose loss adds an adversarial BPR term on
perturbed embeddings:

* ``adv=grad``: delta = eps * the row-normalized gradient of the batch's
  BPR loss with respect to the full tables, taken at detached P and Q
  (``torch.autograd.grad`` without ``create_graph``, as ``jax.grad`` of
  ``stop_gradient`` inputs); rows outside the batch get a zero delta;
* ``adv=random``: delta = eps * row-normalized 0.01 * truncated normal
  noise over the full tables, drawn from ``batch["generator"]``;
* loss = bpr + reg * l2(tables) + [epoch >= adv_epoch] * reg_adv * bpr_adv,
  the switch computed on the device from ``batch["epoch"]`` (a 0-d device
  tensor, as the JAX package's traced epoch), so that a graph of the steps
  kept across epochs turns the term on at ``adv_epoch``.

The adversarial term gathers the batch's rows of P + delta_P and
Q + delta_Q, the same values and gradients as the JAX package's full-table
sums. Evaluation is factorized: K1 at d = ``embedding_size``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neurec_tpu_torch.device import DeviceLike
from neurec_tpu_torch.models.base import Recommender, register
from neurec_tpu_torch.ops.initializers import get_initializer
from neurec_tpu_torch.ops.losses import l2_loss
from neurec_tpu_torch.parallel.mesh import batch_sum, whole_term


def _row_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(torch.square(x), dim=-1, keepdim=True), min=eps))


def _bpr(p_u, q_pos, q_neg, weights):
    y = torch.sum(p_u * (q_pos - q_neg), dim=-1)
    return torch.sum(F.softplus(-y) * weights)


@register("APR")
class APR(Recommender):
    data_kind = "pairwise"

    def __init__(self, dataset, config, device: DeviceLike = None):
        super().__init__(dataset, config, device)
        self.embedding_size = int(config.get("embedding_size", 64))
        self.reg = float(config.get("reg", 0.0))
        self.reg_adv = float(config.get("reg_adv", 1.0))
        self.adv_epoch = int(config.get("adv_epoch", 0))
        self.adv = config.get("adv", "grad")
        self.eps = float(config.get("eps", 0.5))
        self.adver = bool(config.get("adver", 1))
        self.init_method = config.get("init_method", "tnormal")
        self.stddev = float(config.get("stddev", 0.01))

    def init_params(self, generator: torch.Generator):
        init = get_initializer(self.init_method, self.stddev)
        return {
            "embedding_P": init(generator, (self.num_users, self.embedding_size)).to(self.device),
            "embedding_Q": init(generator, (self.num_items, self.embedding_size)).to(self.device),
        }

    def _deltas(self, P, Q, users, pos, neg, weights, generator):
        if self.adv == "grad":
            Pd, Qd = P.detach().requires_grad_(True), Q.detach().requires_grad_(True)
            with torch.enable_grad():
                gP, gQ = torch.autograd.grad(_bpr(Pd[users], Qd[pos], Qd[neg], weights), (Pd, Qd))
            # the whole batch's gradient, then normalised (a split step's is a part)
            return _row_normalize(batch_sum(gP)) * self.eps, _row_normalize(batch_sum(gQ)) * self.eps
        if generator is None:
            raise ValueError("APR adv=random draws its noise from batch['generator']")
        noise = [torch.nn.init.trunc_normal_(torch.empty_like(t), 0.0, 1.0, -2.0, 2.0, generator=generator)
                 for t in (P, Q)]
        return tuple(_row_normalize(0.01 * n) * self.eps for n in noise)

    def loss(self, params, batch, weights):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        # the adversarial gradient and noise are over the whole tables
        P, Q = self.whole(params, "embedding_P"), self.whole(params, "embedding_Q")
        opt_loss = _bpr(P[users], Q[pos], Q[neg], weights) + whole_term(self.reg * l2_loss(P, Q))
        if not self.adver:
            return opt_loss
        dP, dQ = self._deltas(P, Q, users, pos, neg, weights, batch.get("generator"))
        adv_loss = _bpr(P[users] + dP[users], Q[pos] + dQ[pos], Q[neg] + dQ[neg], weights)
        # on from adv_epoch, read on the device (a kept graph of the steps
        # holds the epoch as a tensor it is handed each epoch)
        adv_on = (torch.as_tensor(batch["epoch"], device=P.device) >= self.adv_epoch).to(P.dtype)
        return opt_loss + adv_on * self.reg_adv * adv_loss

    def predict(self, params, users):
        return self.rows(params, "embedding_P", users) @ self.whole(params, "embedding_Q").T

    def eval_embeddings(self, params, users):
        """Factorized eval form for the fused score+mask kernel (K1)."""
        return self.rows(params, "embedding_P", users), self.whole(params, "embedding_Q")
