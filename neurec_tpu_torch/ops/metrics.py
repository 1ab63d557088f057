"""Ranking metrics, vectorized over (batch, rank).

Port of ``neurec_tpu/ops/metrics.py``: given each user's top-K ranked
item ids and ground-truth set, every metric is a length-K vector whose
r-th entry is the metric on the rank-(r+1) prefix:

* Precision@r = hits_r / r
* Recall@r    = hits_r / |truth|
* MAP@r (``ap``) = (sum of precision at hit positions <= r) / min(r, |truth|)
* NDCG@r      = DCG_r / iDCG_r, iDCG over the first |truth| ranks
* MRR@r       = 1/rank of first hit, 0 before the first hit
"""

from __future__ import annotations

import torch

METRIC_NAMES = ("Precision", "Recall", "MAP", "NDCG", "MRR")
METRIC_INDEX = {name: i for i, name in enumerate(METRIC_NAMES)}


def hit_matrix(
    topk_items: torch.Tensor,    # (B, K) ranked item ids
    truth_items: torch.Tensor,   # (B, T) padded ground-truth ids
    truth_lengths: torch.Tensor,  # (B,) number of valid truth entries
) -> torch.Tensor:
    """(B, K) float32 — 1 where the ranked item is in the user's truth set."""
    valid = (
        torch.arange(truth_items.shape[1], device=truth_items.device)[None, :]
        < truth_lengths[:, None]
    )
    eq = topk_items[:, :, None] == truth_items[:, None, :]
    return (eq & valid[:, None, :]).any(dim=-1).to(torch.float32)


def all_metrics(hits: torch.Tensor, truth_lengths: torch.Tensor) -> torch.Tensor:
    """All five metric vectors, (B, 5, K) float32, in METRIC_NAMES order."""
    B, K = hits.shape
    ranks = torch.arange(1, K + 1, dtype=torch.float32, device=hits.device)[None, :]
    truth_len = truth_lengths.to(torch.float32)[:, None]
    cum_hits = torch.cumsum(hits, dim=1)

    # an empty truth row would make recall/ndcg 0/0 = NaN; its hits are all
    # 0, so a clamped denominator gives the right 0 rows instead
    safe_truth = torch.clamp(truth_len, min=1.0)

    precision = cum_hits / ranks
    recall = cum_hits / safe_truth

    sum_pre = torch.cumsum(hits * precision, dim=1)
    ap = torch.where(cum_hits > 0, sum_pre / torch.minimum(ranks, safe_truth), 0.0)

    gains = 1.0 / torch.log2(ranks + 1.0)
    dcg = torch.cumsum(hits * gains, dim=1)
    ideal_mask = (ranks <= truth_len).to(torch.float32)
    idcg = torch.cumsum(ideal_mask * gains, dim=1)
    ndcg = dcg / torch.clamp(idcg, min=1e-12)

    has_hit = cum_hits > 0
    first_hit = torch.argmax((hits > 0).to(torch.uint8), dim=1).to(torch.float32)
    mrr = torch.where(has_hit, 1.0 / (first_hit[:, None] + 1.0), 0.0)

    return torch.stack([precision, recall, ap, ndcg, mrr], dim=1)
