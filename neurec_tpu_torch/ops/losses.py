"""Loss functions with the reference's reduction semantics.

Port of ``neurec_tpu/ops/losses.py`` (util/learner.py:19-41,
util/tool.py:216-224):

* ``pairwise_loss('bpr', y)``    = -sum(log sigmoid(y))       [sum, not mean]
* ``pairwise_loss('hinge', y)``  = sum(max(y + margin, 0))
* ``pairwise_loss('square', y)`` = sum((1 - y)^2)
* ``pointwise_loss('cross_entropy', labels, logits)`` mirrors
  ``tf.losses.sigmoid_cross_entropy`` (mean over nonzero weights).
* ``pointwise_loss('square', labels, preds)`` = sum((labels - preds)^2)
* ``l2_loss(*xs)`` = sum of 0.5 * sum(x^2) (tf.nn.l2_loss semantics).

Every function takes an optional ``weights`` tensor for padded batches
(weight 0 drops the example). In a data-parallel step the cross-entropy
mean divides by the whole batch's weight count
(``parallel.mesh.batch_sum``), so the ranks' losses sum to the whole
batch's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from neurec_tpu_torch.parallel.mesh import batch_sum


def _weighted_sum(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is not None:
        x = x * weights
    return torch.sum(x)


def pairwise_loss(
    loss_function: str,
    y: torch.Tensor,
    margin: float = 1.0,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    lf = loss_function.lower()
    if lf == "bpr":
        # -log sigmoid(y) == softplus(-y), numerically stable
        return _weighted_sum(F.softplus(-y), weights)
    elif lf == "hinge":
        return _weighted_sum(torch.clamp(y + margin, min=0.0), weights)
    elif lf == "square":
        return _weighted_sum(torch.square(1.0 - y), weights)
    raise ValueError("unknown pairwise loss '%s'" % loss_function)


def pointwise_loss(
    loss_function: str,
    labels: torch.Tensor,
    preds: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    lf = loss_function.lower()
    if lf == "cross_entropy":
        # tf.losses.sigmoid_cross_entropy with reduction
        # SUM_BY_NONZERO_WEIGHTS (the mean for unit weights)
        ce = torch.clamp(preds, min=0.0) - preds * labels + F.softplus(-torch.abs(preds))
        if weights is not None:
            denom = torch.clamp(batch_sum(torch.sum(weights)), min=1.0)
            return torch.sum(ce * weights) / denom
        return torch.mean(ce)
    elif lf == "square":
        return _weighted_sum(torch.square(labels - preds), weights)
    raise ValueError("unknown pointwise loss '%s'" % loss_function)


def l2_loss(*params: torch.Tensor) -> torch.Tensor:
    """sum_i 0.5 * ||p_i||^2 — tf.nn.l2_loss summed (util/tool.py:216-217)."""
    return sum(0.5 * torch.sum(torch.square(p)) for p in params)


def log_loss(y: torch.Tensor) -> torch.Tensor:
    """BPR per-element loss -log sigmoid(y) (util/tool.py:220-224)."""
    return F.softplus(-y)
