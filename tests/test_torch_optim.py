"""The port's optimizers against optax, fed the same gradient sequence.

``make_optimizer`` must give the JAX package's ``make_optimizer`` updates
for each of the five learners: params after 3 steps within rtol 1e-5 /
atol 1e-7 (f32, other operation orders). Adam is held there too: the
port's ``OptaxAdam`` computes the bias correction 1 - 0.999^t in f32 as
optax does, where ``torch.optim.Adam``'s float64 one is ~2e-5 of a step
away at t = 3 (the test below shows it). The gradients include exact
zeros and values near eps, where adagrad's ``where(acc > 0)`` and
rmsprop's eps inside the square root decide the update. An Adam state
moves between optax and ``torch.optim.Adam`` through ``bridge``
without changing the run.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurec_tpu.trainer import make_optimizer as jax_make_optimizer
from neurec_tpu_torch.bridge import adam_state_from_numpy, adam_state_to_numpy
from neurec_tpu_torch.trainer import make_optimizer

LEARNERS = ["adam", "gd", "momentum", "adagrad", "rmsprop"]


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"user_emb": rng.randn(6, 4).astype(np.float32), "item_emb": rng.randn(9, 4).astype(np.float32)}


def _grads(seed, n_steps):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in _params().items()}
        g["user_emb"][0] = 0.0           # no gradient at all
        g["user_emb"][1] *= 1e-5          # near sqrt(eps)
        g["item_emb"][2] *= 1e-9          # below eps
        out.append(g)
    return out


def _run_optax(tx, params, grads, state=None):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params) if state is None else state
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}, state


def _torch_params(params):
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}


def _run_torch(opt, params, grads):
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: v.detach().numpy() for k, v in params.items()}


@pytest.mark.parametrize("learner", LEARNERS)
def test_learner_matches_optax(learner):
    grads = _grads(1, 3)
    want, _ = _run_optax(jax_make_optimizer(learner, 0.05), _params(), grads)
    params = _torch_params(_params())
    got = _run_torch(make_optimizer(learner, 0.05)(params.values()), params, grads)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg="%s %s" % (learner, k))
    np.testing.assert_array_equal(got["user_emb"][0], _params()["user_emb"][0])  # zero grads: no move


def test_torch_adam_float64_bias_correction_misses_optax():
    """The reason for ``OptaxAdam``: ``torch.optim.Adam`` is outside 1e-7."""
    grads = _grads(1, 3)
    want, _ = _run_optax(jax_make_optimizer("adam", 0.05), _params(), grads)
    params = _torch_params(_params())
    got = _run_torch(torch.optim.Adam(params.values(), lr=0.05), params, grads)
    assert max(np.abs(got[k] - want[k]).max() for k in want) > 1e-7


def test_unknown_learner_raises():
    with pytest.raises(ValueError):
        make_optimizer("lbfgs", 0.1)


def test_adam_state_carries_between_packages():
    """3 optax steps, the state into torch, 2 more steps in each package:
    the same params; then torch -> numpy -> torch gives the same state."""
    grads = _grads(2, 5)
    tx = jax_make_optimizer("adam", 0.01)
    mid, state = _run_optax(tx, _params(), grads[:3])
    want, _ = _run_optax(tx, mid, grads[3:], state=state)

    adam = state[0]
    assert isinstance(adam, optax.ScaleByAdamState)
    params = _torch_params(mid)
    opt = make_optimizer("adam", 0.01)(params.values())
    adam_state_from_numpy(opt, params, np.asarray(adam.count),
                          {k: np.asarray(v) for k, v in adam.mu.items()},
                          {k: np.asarray(v) for k, v in adam.nu.items()})
    got = _run_torch(opt, params, grads[3:])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)

    count, mu, nu = adam_state_to_numpy(opt, params)
    assert count.dtype == np.int32 and int(count) == 5
    again = make_optimizer("adam", 0.01)(params.values())
    adam_state_from_numpy(again, params, count, mu, nu)
    for p in params.values():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(again.state[p][key], opt.state[p][key]), key
    # and back into optax: the moments are the ones optax would hold
    _, state5 = _run_optax(tx, _params(), grads)
    for k in mu:
        np.testing.assert_allclose(mu[k], np.asarray(state5[0].mu[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(nu[k], np.asarray(state5[0].nu[k]), rtol=1e-5, atol=1e-12)
    assert int(state5[0].count) == int(count)


def test_fresh_adam_state_is_optax_init():
    params = _torch_params(_params())
    opt = make_optimizer("adam", 0.01)(params.values())
    count, mu, nu = adam_state_to_numpy(opt, params)
    init = jax_make_optimizer("adam", 0.01).init({k: jnp.asarray(v) for k, v in _params().items()})[0]
    assert int(count) == int(init.count) == 0
    for k in mu:
        np.testing.assert_array_equal(mu[k], np.asarray(init.mu[k]))
        np.testing.assert_array_equal(nu[k], np.asarray(init.nu[k]))
