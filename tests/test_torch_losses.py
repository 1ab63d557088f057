"""The port's losses and initializers against the JAX package's.

Losses: every loss and reduction, with and without weights (some of them
0), on the same numpy inputs; tolerance rtol 1e-6 / atol 1e-6 (the same
f32 arithmetic, another summation order). Initializers draw from another
generator than JAX's, so each scheme is held to its distribution: support,
mean and standard deviation over 40,000 draws, within 5% of the std.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import losses as jax_losses
from neurec_tpu_torch.ops import initializers, losses


def _inputs(seed, n=257):
    rng = np.random.RandomState(seed)
    y = (rng.randn(n) * 4).astype(np.float32)  # reaches the softplus tails
    labels = (rng.rand(n) < 0.4).astype(np.float32)
    weights = (rng.rand(n) < 0.8).astype(np.float32)
    return y, labels, weights


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["bpr", "hinge", "square", "BPR"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pairwise_loss_matches_jax(fn, weighted):
    y, _, weights = _inputs(0)
    w = weights if weighted else None
    got = losses.pairwise_loss(fn, torch.from_numpy(y), margin=0.5,
                               weights=None if w is None else torch.from_numpy(w))
    want = jax_losses.pairwise_loss(fn, jnp.asarray(y), margin=0.5,
                                    weights=None if w is None else jnp.asarray(w))
    _close(got, want)


@pytest.mark.parametrize("fn", ["cross_entropy", "square"])
@pytest.mark.parametrize("weights_kind", ["none", "some zero", "all zero"])
def test_pointwise_loss_matches_jax(fn, weights_kind):
    y, labels, weights = _inputs(1)
    w = {"none": None, "some zero": weights, "all zero": np.zeros_like(weights)}[weights_kind]
    got = losses.pointwise_loss(fn, torch.from_numpy(labels), torch.from_numpy(y),
                                weights=None if w is None else torch.from_numpy(w))
    want = jax_losses.pointwise_loss(fn, jnp.asarray(labels), jnp.asarray(y),
                                     weights=None if w is None else jnp.asarray(w))
    _close(got, want)


def test_l2_and_log_loss_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)
    _close(losses.l2_loss(torch.from_numpy(a), torch.from_numpy(b)),
           jax_losses.l2_loss(jnp.asarray(a), jnp.asarray(b)))
    y, _, _ = _inputs(3)
    _close(losses.log_loss(torch.from_numpy(y)), jax_losses.log_loss(jnp.asarray(y)))


def test_unknown_losses_raise():
    y = torch.zeros(3)
    with pytest.raises(ValueError):
        losses.pairwise_loss("nope", y)
    with pytest.raises(ValueError):
        losses.pointwise_loss("nope", y, y)


# (scheme, shape, want std, support bound or None); stddev = 0.01
_INIT_CASES = [
    ("normal", (200, 200), 0.01, None),
    ("tnormal", (200, 200), 0.01 * 0.87962566103423978, 0.02),
    ("uniform", (200, 200), 0.01 / np.sqrt(3.0), 0.01),
    ("xavier_uniform", (100, 400), np.sqrt(2.0 / 500), np.sqrt(6.0 / 500)),
    ("xavier_normal", (100, 400), np.sqrt(2.0 / 500), 2 * np.sqrt(2.0 / 500) / 0.87962566103423978),
    ("he_uniform", (100, 400), np.sqrt(2.0 / 100), np.sqrt(6.0 / 100)),
    ("he_normal", (100, 400), np.sqrt(2.0 / 100), 2 * np.sqrt(2.0 / 100) / 0.87962566103423978),
    ("xavier_uniform", (40000,), np.sqrt(1.0 / 40000), np.sqrt(3.0 / 40000)),  # TF rank-1 fans
    ("he_normal", (40000,), np.sqrt(2.0 / 40000), 2 * np.sqrt(2.0 / 40000) / 0.87962566103423978),
]


@pytest.mark.parametrize("scheme,shape,std,bound", _INIT_CASES)
def test_initializer_distributions(scheme, shape, std, bound):
    init = initializers.get_initializer(scheme, 0.01)
    x = init(torch.Generator().manual_seed(0), shape)
    assert x.shape == shape and x.dtype == torch.float32
    assert abs(float(x.mean())) < 0.05 * std
    assert abs(float(x.std()) - std) < 0.05 * std
    if bound is not None:
        assert float(x.abs().max()) <= bound * (1 + 1e-6)
    # the same seed gives the same draws
    assert torch.equal(x, init(torch.Generator().manual_seed(0), shape))


def test_constant_initializers_and_glorot():
    g = torch.Generator().manual_seed(1)
    assert torch.equal(initializers.get_initializer("zeros")(g, (2, 3)), torch.zeros(2, 3))
    assert torch.equal(initializers.get_initializer("ones")(g, (4,)), torch.ones(4))
    a = initializers.glorot_uniform(torch.Generator().manual_seed(2), (30, 50))
    b = initializers.get_initializer("xavier_uniform")(torch.Generator().manual_seed(2), (30, 50))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        initializers.get_initializer("nope")
