"""The bridge on nested parameter trees (lists of dicts, as the towers'
``[{"w", "b"}]``, ConvNCF's ``conv`` and DeepICF's ``bn``).

* JAX ``init_params`` trees go into the port and back unchanged: the same
  leaf paths as ``jax.tree_util``'s, keys, shapes, dtypes and values exact,
  and a copy (training in place must not reach the caller's arrays).
* The optax Adam state of a nested tree loads into ``OptaxAdam`` over the
  port's tensors, a few steps run in both packages on the same gradients,
  and the moments and params come back to within rtol 1e-5 / atol 1e-7
  (optax's f32 arithmetic is mirrored, see test_torch_optim.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurec_tpu.data.synthetic import DictConfig as JaxDictConfig
from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.models import get_model as jax_get_model
from neurec_tpu_torch.bridge import (
    adam_state_from_numpy,
    adam_state_to_numpy,
    map_params,
    param_leaves,
    params_from_numpy,
    params_to_numpy,
)
from neurec_tpu_torch.trainer import OptaxAdam

NESTED = {
    "NeuMF": {"embedding_size": 4, "layers": [8, 4, 2]},
    "ConvNCF": {"embedding_size": 4, "net_channel": [3, 2]},
    "DeepICF": {"embedding_size": 4, "weight_size": 2, "layers": [4, 2], "batch_norm": True},
}


def _jax_tree(name):
    ds = jax_random_dataset(num_users=12, num_items=20, seed=0)
    model = jax_get_model(name)(ds, JaxDictConfig(NESTED[name]))
    return jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(1)))


def _jax_paths(tree):
    """jax.tree_util's leaf paths as the bridge's tuples of keys and indices."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)] = leaf
    return out


@pytest.mark.parametrize("name", sorted(NESTED))
def test_round_trip_keeps_the_tree(name):
    tree = _jax_tree(name)
    port = params_from_numpy(tree, "cpu")
    leaves = dict(param_leaves(port))
    want = _jax_paths(tree)
    assert set(leaves) == set(want)
    assert any(len(path) == 3 for path in leaves)  # a list of dicts
    for path, t in leaves.items():
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == want[path].shape
    back = params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (_, a), (_, b) in zip(param_leaves(back), param_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    next(iter(leaves.values())).add_(1.0)  # a copy: the caller's arrays stay
    np.testing.assert_array_equal(params_to_numpy(params_from_numpy(tree, "cpu"))[next(iter(tree))],
                                  tree[next(iter(tree))])


def test_map_params_walks_lists_of_dicts():
    tree = {"a": [{"w": 1, "b": 2}, {"w": 3, "b": 4}], "c": 5, "d": [6, 7]}
    assert map_params(lambda v: v * 10, tree) == {"a": [{"w": 10, "b": 20}, {"w": 30, "b": 40}], "c": 50,
                                                   "d": [60, 70]}
    assert [p for p, _ in param_leaves(tree)] == [("a", 0, "w"), ("a", 0, "b"), ("a", 1, "w"), ("a", 1, "b"),
                                                  ("c",), ("d", 0), ("d", 1)]


@pytest.mark.parametrize("name", sorted(NESTED))
def test_adam_state_of_a_nested_tree_against_optax(name):
    tree = _jax_tree(name)
    rng = np.random.RandomState(2)
    tx = optax.adam(0.01)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state_j = tx.init(params_j)
    grads = [jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree) for _ in range(5)]
    for g in grads[:2]:
        updates, state_j = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)

    # the JAX state after 2 steps moves into the port, 3 more steps in each
    params = map_params(lambda t: t.requires_grad_(True),
                        params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j), "cpu"))
    opt = OptaxAdam([p for _, p in param_leaves(params)], lr=0.01)
    adam = state_j[0]
    adam_state_from_numpy(opt, params, adam.count, jax.tree_util.tree_map(np.asarray, adam.mu),
                          jax.tree_util.tree_map(np.asarray, adam.nu))
    for g in grads[2:]:
        updates, state_j = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        g_paths = dict(param_leaves(g))
        for path, p in param_leaves(params):
            p.grad = torch.from_numpy(g_paths[path])
        opt.step()
    count, mu, nu = adam_state_to_numpy(opt, params)
    assert int(count) == int(state_j[0].count) == 5
    for got, want in ((params_to_numpy(params), params_j), (mu, state_j[0].mu), (nu, state_j[0].nu)):
        want = dict(param_leaves(jax.tree_util.tree_map(np.asarray, want)))
        for path, a in param_leaves(got):
            np.testing.assert_allclose(a, want[path], rtol=1e-5, atol=1e-7, err_msg=str(path))
