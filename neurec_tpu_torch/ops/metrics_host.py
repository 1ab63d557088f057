"""Pure-numpy per-user metric oracle (port of ``neurec_tpu/ops/metrics_host.py``),
a line-for-line behavioral mirror of the reference C++ kernels
(evaluator/backend/cpp/include/metric.h:17-109).

The port's own oracle for the vectorized ``ops/metrics.py`` and for the
native host tier (``native/``), as the reference pairs its python and cpp
backends (evaluator/backend/__init__.py:1-6).
"""

from __future__ import annotations

import math
from typing import Sequence, Set

import numpy as np


def precision(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    out = np.zeros(len(rank), dtype=np.float32)
    hits = 0
    for i, r in enumerate(rank):
        if r in truth:
            hits += 1
        out[i] = hits / (i + 1)
    return out


def recall(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    out = np.zeros(len(rank), dtype=np.float32)
    hits = 0
    for i, r in enumerate(rank):
        if r in truth:
            hits += 1
        out[i] = hits / len(truth)
    return out


def ap(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    out = np.zeros(len(rank), dtype=np.float32)
    hits = 0
    sum_pre = 0.0
    for i, r in enumerate(rank):
        if r in truth:
            hits += 1
            sum_pre += hits / (i + 1)
        denominator = min(len(truth), i + 1)
        out[i] = 0.0 if hits == 0 else sum_pre / denominator
    return out


def ndcg(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    out = np.zeros(len(rank), dtype=np.float32)
    dcg = 0.0
    idcg = 0.0
    for i, r in enumerate(rank):
        if r in truth:
            dcg += 1.0 / math.log2(i + 2)
        if i < len(truth):
            idcg += 1.0 / math.log2(i + 2)
        out[i] = dcg / idcg
    return out


def mrr(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    out = np.zeros(len(rank), dtype=np.float32)
    for i, r in enumerate(rank):
        if r in truth:
            out[i:] = 1.0 / (i + 1)
            break
    return out


METRIC_FNS = {
    "Precision": precision,
    "Recall": recall,
    "MAP": ap,
    "NDCG": ndcg,
    "MRR": mrr,
}


def all_metrics_host(rank: Sequence[int], truth: Set[int]) -> np.ndarray:
    """(5, K) array ordered like ops.metrics.METRIC_NAMES."""
    return np.stack(
        [METRIC_FNS[name](rank, truth) for name in
         ("Precision", "Recall", "MAP", "NDCG", "MRR")]
    )
