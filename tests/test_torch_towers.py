"""``ops/towers.py`` and ``ops/activations.py`` against the JAX package's.

* ``apply_dense_stack`` on the same numpy layers and input as
  ``neurec_tpu.ops.towers.apply_dense_stack``, with each
  ``final_activation`` meaning ("same", None, another function): rtol 1e-5
  / atol 1e-6 (f32 products).
* ``init_dense_stack``: the JAX stack's shapes and dtypes, glorot_uniform
  kernels (inside +-sqrt(6 / (fan_in + fan_out)), the uniform variance) and
  zero biases; the draws are torch's, not threefry's.
* Every named activation on the same values, rtol 1e-6 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import activations as jax_activations
from neurec_tpu.ops import towers as jax_towers
from neurec_tpu_torch.bridge import params_from_numpy
from neurec_tpu_torch.ops import activations, towers


@pytest.mark.parametrize("final", ["same", None, "sigmoid"])
def test_apply_dense_stack_matches_jax(final):
    rng = np.random.RandomState(0)
    dims = [12, 8, 6, 3]
    layers = [{"w": rng.randn(a, b).astype(np.float32), "b": rng.randn(b).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    x = rng.randn(5, 7, 12).astype(np.float32)
    jax_final = jax.nn.sigmoid if final == "sigmoid" else final
    torch_final = torch.sigmoid if final == "sigmoid" else final
    want = jax_towers.apply_dense_stack(jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x),
                                        jnp.tanh, jax_final)
    got = towers.apply_dense_stack(params_from_numpy(layers, "cpu"), torch.from_numpy(x), torch.tanh, torch_final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_init_dense_stack_is_glorot_uniform_with_zero_biases():
    units = [256, 128, 64]
    want = jax_towers.init_dense_stack(jax.random.PRNGKey(0), 512, units)
    got = towers.init_dense_stack(torch.Generator().manual_seed(0), 512, units)
    assert len(got) == len(want)
    for g, w, (fan_in, fan_out) in zip(got, want, zip([512] + units[:-1], units)):
        assert g["w"].shape == w["w"].shape and g["b"].shape == w["b"].shape
        assert g["w"].dtype == torch.float32 and g["b"].dtype == torch.float32
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert float(g["w"].abs().max()) <= limit
        np.testing.assert_allclose(float(g["w"].var()), limit ** 2 / 3.0, rtol=0.05)
        assert not g["b"].any()


@pytest.mark.parametrize("name", sorted(jax_activations._ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.random.RandomState(1).randn(4, 9).astype(np.float32) * 3
    want = jax_activations.activation_function(name.upper())(jnp.asarray(x))
    got = activations.activation_function(name.upper())(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_unknown_activation_raises():
    with pytest.raises(NotImplementedError, match="unknown activation"):
        activations.activation_function("swish")
