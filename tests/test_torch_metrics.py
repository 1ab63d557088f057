"""Ranking metrics in the port against the JAX package, to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import metrics as jax_metrics
from neurec_tpu_torch.ops import metrics


def _case(seed, B=64, K=20, T=12, I=60):
    rng = np.random.RandomState(seed)
    topk = np.stack([rng.choice(I, K, replace=False) for _ in range(B)]).astype(np.int32)
    lens = rng.randint(0, T + 1, B).astype(np.int32)
    lens[:3] = 0  # empty truth rows
    truth = np.full((B, T), I, dtype=np.int32)
    for b in range(B):
        truth[b, : lens[b]] = rng.choice(I, lens[b], replace=False)
    return topk, truth, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    topk, truth, lens = _case(seed)
    hits_j = jax_metrics.hit_matrix(jnp.asarray(topk), jnp.asarray(truth), jnp.asarray(lens))
    hits = metrics.hit_matrix(torch.from_numpy(topk), torch.from_numpy(truth), torch.from_numpy(lens))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_j))
    want = np.asarray(jax_metrics.all_metrics(hits_j, jnp.asarray(lens)))
    got = metrics.all_metrics(hits, torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (len(lens), 5, topk.shape[1])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:3] == 0).all()  # the empty-truth clamp gives zero rows
    assert metrics.METRIC_NAMES == jax_metrics.METRIC_NAMES
    assert metrics.METRIC_INDEX == jax_metrics.METRIC_INDEX
