"""K2 (plan SpMM) and the graph ops in the port against the JAX package.

The plan builder must give identical arrays, the plain version must match
JAX's Pallas kernel (interpret mode) to atol/rtol 1e-5, the adjacency must
match for every adj_type, and each of ``spmm``'s three branches must give
A @ x. The CUDA kernel is held to its plain version on a card in
test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import graph as jax_graph
from neurec_tpu.ops import pallas_spmm as jax_spmm
from neurec_tpu_torch.data.synthetic import random_dataset
from neurec_tpu_torch.ops import graph, spmm

torch.set_float32_matmul_precision("highest")


def _random_coo(seed, n_rows, n_src, nnz, empty_tail=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows - empty_tail, nnz).astype(np.int32)
    cols = rng.integers(0, n_src, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[:nnz // 20] = 0.0  # build padding must be dropped
    return rows, cols, vals


PLAN_CASES = [  # (n_rows, n_src, nnz, tile_r, chunk, empty_tail)
    (997, 773, 6000, 128, 128, 0),   # non-tile-multiple rows
    (1000, 700, 4000, 256, 256, 500),  # empty tiles at the end
    (512, 100, 300, 128, 64, 400),   # one populated tile
    (300, 50, 0, 256, 256, 0),       # no edges at all
]


@pytest.mark.parametrize("n_rows,n_src,nnz,tile_r,chunk,empty_tail", PLAN_CASES)
def test_plan_builder_array_identical(n_rows, n_src, nnz, tile_r, chunk, empty_tail):
    rows, cols, vals = _random_coo(0, n_rows, n_src, nnz, empty_tail)
    want = jax_spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk)
    got = spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk)
    for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.n_rows, got.tile_r) == (want.n_rows, want.tile_r)


@pytest.mark.parametrize("n_rows,n_src,nnz,tile_r,chunk,empty_tail", PLAN_CASES)
@pytest.mark.parametrize("d", [8, 32])
def test_plan_spmm_reference_matches_jax_interpret(n_rows, n_src, nnz, tile_r, chunk, empty_tail, d):
    rows, cols, vals = _random_coo(1, n_rows, n_src, nnz, empty_tail)
    x = np.random.default_rng(2).standard_normal((n_src, d)).astype(np.float32)
    jplan = jax_spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk)
    want = np.asarray(jax_spmm.plan_spmm(jplan, jnp.asarray(x), interpret=True))
    plan = spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk).to("cpu")
    for fn in (spmm.plan_spmm_reference, spmm.plan_spmm):  # CPU dispatch
        got = fn(plan, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("adj_type", ["plain", "norm", "gcmc", "pre", "mean"])
def test_norm_adjacency_matches_jax(adj_type):
    ds = random_dataset(num_users=60, num_items=90, seed=3)  # some items unseen
    want = jax_graph.build_norm_adjacency(ds.train_matrix, adj_type)
    got = graph.build_norm_adjacency(ds.train_matrix, adj_type, device="cpu")
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.n_nodes == want.n_nodes
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want.dense))
    assert got.plan is None and want.plan is None


def test_large_adjacency_takes_the_plan_branch():
    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    assert (6000 + 3000) ** 2 > graph.DENSE_LIMIT
    want = jax_graph.build_norm_adjacency(ds.train_matrix, "pre")
    got = graph.build_norm_adjacency(ds.train_matrix, "pre", device="cpu")
    assert got.dense is None
    for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first"):
        np.testing.assert_array_equal(getattr(got.plan, name).numpy(), np.asarray(getattr(want.plan, name)))


@pytest.mark.parametrize("branch", ["dense", "plan", "segment"])
def test_spmm_branches(branch, monkeypatch):
    """Each package forced onto the same branch (JAX's plan branch runs its
    Pallas kernel in interpret mode)."""
    ds = random_dataset(num_users=70, num_items=50, seed=5)
    adj = graph.build_norm_adjacency(ds.train_matrix, "pre", device="cpu")
    jadj = jax_graph.build_norm_adjacency(ds.train_matrix, "pre")
    dense = adj.dense.numpy()
    if branch == "plan":
        monkeypatch.setenv("NEUREC_PALLAS_INTERPRET", "1")
        coo = (adj.rows.numpy(), adj.cols.numpy(), adj.vals.numpy())
        adj = adj._replace(dense=None, plan=spmm.build_spmm_plan(
            *coo, adj.n_nodes, tile_r=32, chunk=16).to("cpu"))
        jadj = jadj._replace(
            dense=None,
            plan=jax_spmm.build_spmm_plan(*coo, adj.n_nodes, tile_r=32, chunk=16),
            plan_t=jax_spmm.build_spmm_plan(coo[1], coo[0], coo[2], adj.n_nodes, tile_r=32, chunk=16),
        )
    elif branch == "segment":
        adj = adj._replace(dense=None)
        jadj = jadj._replace(dense=None)
    x = np.random.default_rng(6).standard_normal((adj.n_nodes, 16)).astype(np.float32)
    got = graph.spmm(adj, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_graph.spmm(jadj, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, dense @ x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("adj_type", ["gcmc", "norm"])
def test_transposed_plan_array_identical(adj_type):
    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    want = jax_graph.build_norm_adjacency(ds.train_matrix, adj_type)
    got = graph.build_norm_adjacency(ds.train_matrix, adj_type, device="cpu")
    assert got.plan_t.transposed and not got.plan.transposed
    for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first"):
        np.testing.assert_array_equal(getattr(got.plan_t, name).numpy(), np.asarray(getattr(want.plan_t, name)))
    assert (got.plan_t.n_rows, got.plan_t.tile_r) == (want.plan_t.n_rows, want.plan_t.tile_r)
    # a non-symmetric adjacency: the transposed plan has its own structure
    assert not np.array_equal(got.plan_t.vals.numpy(), got.plan.vals.numpy())


def _small_plans(adj_type, tile_r=32, chunk=16):
    ds = random_dataset(num_users=70, num_items=50, seed=8)
    adj = graph.build_norm_adjacency(ds.train_matrix, adj_type, device="cpu")
    coo = (adj.rows.numpy(), adj.cols.numpy(), adj.vals.numpy())
    n = adj.n_nodes
    jplan = jax_spmm.build_spmm_plan(*coo, n, tile_r=tile_r, chunk=chunk)
    jplan_t = jax_spmm.build_spmm_plan(coo[1], coo[0], coo[2], n, tile_r=tile_r, chunk=chunk)
    plan = spmm.build_spmm_plan(*coo, n, tile_r=tile_r, chunk=chunk).to("cpu")
    plan_t = spmm.build_spmm_plan(coo[1], coo[0], coo[2], n, tile_r=tile_r, chunk=chunk)
    plan_adj = adj._replace(dense=None, plan=plan, plan_t=plan_t._replace(transposed=True).to("cpu"))
    return adj.dense.numpy(), plan_adj, jplan, jplan_t


@pytest.mark.parametrize("adj_type", ["gcmc", "norm", "mean"])
def test_plan_spmm_gradient_matches_jax_vjp(adj_type):
    """d/dx sum(g * (A @ x)) = A^T @ g: the port's PlanSpmm backward
    against jax.grad through make_spmm (Pallas, interpret mode) and the
    dense A^T @ g; atol/rtol 1e-5."""
    import jax

    dense, plan_adj, jplan, jplan_t = _small_plans(adj_type)
    assert not np.allclose(dense, dense.T)  # a backward without the transpose would fail
    rng = np.random.default_rng(9)
    x = rng.standard_normal((dense.shape[0], 12)).astype(np.float32)
    g = rng.standard_normal((dense.shape[0], 12)).astype(np.float32)
    f = jax_spmm.make_spmm(jplan, jplan_t, interpret=True, compute_dtype=None)
    want = np.asarray(jax.grad(lambda v: jnp.sum(f(v) * jnp.asarray(g)))(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = graph.spmm(plan_adj, xt)
    np.testing.assert_allclose(out.detach().numpy(), dense @ x, atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), dense.T @ g, atol=1e-5, rtol=1e-5)


def test_plan_spmm_backward_goes_through_the_module_wrapper(monkeypatch):
    """PlanSpmm looks ``plan_spmm`` up at call time: a replacement reaches
    the forward (over plan) and the backward (over plan_t, given a
    contiguous gradient even when autograd hands it a strided view)."""
    _, plan_adj, _, _ = _small_plans("gcmc")
    calls = []

    def spy(plan, x):
        calls.append((plan.transposed, x.is_contiguous()))
        return spmm.plan_spmm_reference(plan, x)

    monkeypatch.setattr(spmm, "plan_spmm", spy)
    x = torch.randn(plan_adj.n_nodes, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out = graph.spmm(plan_adj, x)
    # the gradient of out.T arrives at out as a transposed, strided view
    (out.T * torch.arange(out.numel(), dtype=torch.float32).reshape(out.T.shape)).sum().backward()
    assert calls == [(False, True), (True, True)]
    with torch.no_grad():
        graph.spmm(plan_adj, x)
    assert len(calls) == 3
    with pytest.raises(ValueError, match="transposed plan"):
        graph.spmm(plan_adj._replace(plan_t=None), x).sum().backward()
