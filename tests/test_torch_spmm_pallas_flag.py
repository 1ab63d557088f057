"""``NEUREC_SPMM_PALLAS`` in the port, against the JAX package's reading.

The JAX package reads the variable at each call
(``neurec_tpu/ops/graph.py::_pallas_spmm_enabled``): with ``0``, ``spmm``
and ``spmm_sharded`` take the sorted-COO segment sum over a graph that has
plans; otherwise the plan kernel. The port's ``spmm`` and ``spmm_sharded``
(``neurec_tpu_torch/ops/graph.py``) read it the same way:

* one rank: with ``0`` the forward and the backward make no
  ``plan_spmm`` call, and A @ x is the segment sum over the edges bit for
  bit (the same ``index_add_``) and the JAX package's ``spmm`` within 1e-6;
  unset, ``auto`` or ``1``, the forward and the backward each make one
  call (over the plan, then the transposed plan) and agree with the
  segment sum within 1e-5;
* a 2-rank gloo world (``tests/torch_spmm_flag_worker.py``): the sharded
  SpMM, with its block plans, makes no plan call under ``0`` and one each
  way otherwise, and both routes give one rank's A @ x and gradient
  within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.data.synthetic import random_dataset as jax_random_dataset
from neurec_tpu.ops import graph as jax_graph
from neurec_tpu_torch.data.synthetic import random_dataset
from neurec_tpu_torch.ops import graph
from neurec_tpu_torch.ops import spmm as spmm_ops
from tests import torch_mesh_worker as W
from tests.torch_spmm_flag_worker import sharded_flag_case

torch.set_float32_matmul_precision("highest")

FLAGS = [None, "auto", "1", "0"]


@pytest.fixture
def planned(monkeypatch):
    """A normalized adjacency with plans (the dense cutoff at 0), its JAX
    twin and seeded x, w."""
    monkeypatch.setattr(graph, "DENSE_LIMIT", 0)
    ds = random_dataset(num_users=50, num_items=70, seed=4)
    ds_j = jax_random_dataset(num_users=50, num_items=70, seed=4)
    assert (ds.train_matrix != ds_j.train_matrix).nnz == 0
    adj = graph.build_norm_adjacency(ds.train_matrix, "pre", device="cpu")
    assert adj.plan is not None and adj.dense is None
    monkeypatch.setattr(jax_graph, "DENSE_LIMIT", 0)
    adj_j = jax_graph.build_norm_adjacency(ds_j.train_matrix, "pre")
    rng = np.random.RandomState(9)
    x = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    w = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    return adj, adj_j, x, w


def counted(monkeypatch):
    calls = []
    real = spmm_ops.plan_spmm

    def counting(plan, x):
        calls.append(plan.transposed)
        return real(plan, x)

    monkeypatch.setattr(spmm_ops, "plan_spmm", counting)
    return calls


def set_flag(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv("NEUREC_SPMM_PALLAS", raising=False)
    else:
        monkeypatch.setenv("NEUREC_SPMM_PALLAS", flag)


def segment_sum(adj, x):
    out = torch.zeros((adj.n_nodes, x.shape[1]), dtype=torch.float32)
    return out.index_add_(0, adj.rows.long(), x[adj.cols.long()] * adj.vals[:, None])


@pytest.mark.parametrize("flag", FLAGS)
def test_spmm_route_follows_the_flag(planned, flag, monkeypatch):
    adj, adj_j, x_np, w_np = planned
    calls = counted(monkeypatch)
    set_flag(monkeypatch, flag)
    assert graph.plan_kernels_enabled() == (flag != "0")
    x = torch.from_numpy(x_np).requires_grad_(True)
    out = graph.spmm(adj, x)
    (out * torch.from_numpy(w_np)).sum().backward()
    want = segment_sum(adj, torch.from_numpy(x_np))
    if flag == "0":
        assert calls == []
        assert torch.equal(out.detach(), want)
        out_j = np.asarray(jax_graph.spmm(adj_j, jnp.asarray(x_np)))
        np.testing.assert_allclose(out.detach().numpy(), out_j, atol=1e-6, rtol=0)
    else:
        assert calls == [False, True]  # the forward's plan, then the backward's transposed plan
        np.testing.assert_allclose(out.detach().numpy(), want.numpy(), atol=1e-5, rtol=0)
    # d/dx sum((A x) * w) = A^T w on either route
    grad_want = segment_sum(adj._replace(rows=adj.cols, cols=adj.rows), torch.from_numpy(w_np))
    np.testing.assert_allclose(x.grad.numpy(), grad_want.numpy(), atol=1e-5, rtol=0)


def test_the_flag_is_read_at_each_call(planned, monkeypatch):
    adj, _, x_np, _ = planned
    calls = counted(monkeypatch)
    x = torch.from_numpy(x_np)
    with torch.no_grad():
        for flag, n in (("0", 0), (None, 1), ("0", 1), ("auto", 2)):
            set_flag(monkeypatch, flag)
            graph.spmm(adj, x)
            assert len(calls) == n, flag


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    cases = [(str(flag), sharded_flag_case, (flag,), {}) for flag in FLAGS]
    return W.run_world(2, 1, cases, str(tmp_path_factory.mktemp("spmm_flag")))


@pytest.mark.parametrize("flag", FLAGS)
def test_sharded_spmm_route_follows_the_flag(world_results, flag):
    for rank in world_results:
        got = rank[str(flag)]
        assert got["has_plans"]
        assert got["calls"] == ([] if flag == "0" else [False, True])
    # every rank holds the whole product and the whole gradient
    single = W.spmm_case(None)
    for rank in world_results:
        np.testing.assert_allclose(rank[str(flag)]["out"], single["out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(rank[str(flag)]["grad"], single["grad"], atol=1e-5, rtol=0)
