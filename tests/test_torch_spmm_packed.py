"""The SpMM variables, the plan geometry, bf16 features and K3 (the
lane-packed plan SpMM) in the port against the JAX package, on the CPU.

* ``pack_factor`` and ``spmm_compute_dtype`` give the JAX functions'
  answers (and raise where they raise) under the same environment; the
  port's ``auto`` dtype is f32, as the JAX one is on the CPU.
* Under ``NEUREC_SPMM_TILE`` / ``NEUREC_SPMM_CHUNK`` the plans equal the
  JAX package's array for array.
* K3's plain version, and K2's in bf16, match the JAX package's Pallas
  kernels in interpret mode (pack 2 and 4, d 32 and 64, tail chunks and
  empty tiles, f32 and bf16) to atol 1e-5 + rtol 1e-5. In bf16 the edge
  values are rounded to bf16 as the TPU kernel's selector is; keeping them
  in f32 misses by ~4e-3 relative, which these tolerances catch.
* Gradients through ``PlanSpmm`` — packed and unpacked, f32 and bf16 — on
  a non-symmetric (``norm``) adjacency match ``jax.grad`` of ``make_spmm``
  in interpret mode, to the same tolerance.
The CUDA kernels are held to these plain versions on a card in
test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurec_tpu.ops import graph as jax_graph
from neurec_tpu.ops import pallas_spmm as jax_spmm
from neurec_tpu_torch.data.synthetic import random_dataset
from neurec_tpu_torch.ops import graph, spmm

torch.set_float32_matmul_precision("highest")
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag", ["", "auto", "0", "1", "2", "4", "8"])
@pytest.mark.parametrize("d,chunk", [(16, 256), (32, 256), (64, 512), (64, 6), (128, 2), (48, 256)])
def test_pack_factor_matches_jax(monkeypatch, flag, d, chunk):
    monkeypatch.setenv("NEUREC_SPMM_PACK", flag)
    assert spmm.pack_factor(d, chunk) == jax_spmm._pack_factor(d, chunk)


def test_pack_factor_engages_at_64_not_16(monkeypatch):
    for flag, want in (("2", 2), ("4", 4)):
        monkeypatch.setenv("NEUREC_SPMM_PACK", flag)
        assert spmm.pack_factor(64, 512) == want and spmm.pack_factor(16, 256) == 1
    monkeypatch.setenv("NEUREC_SPMM_PACK", "two")
    for fn in (spmm.pack_factor, jax_spmm._pack_factor):
        with pytest.raises(ValueError):
            fn(64, 512)


@pytest.mark.parametrize("flag", ["f32", "float32", "bf16", "bfloat16", "auto"])
def test_compute_dtype_matches_jax(monkeypatch, flag):
    monkeypatch.setenv("NEUREC_SPMM_DTYPE", flag)
    want = jax_spmm._spmm_compute_dtype()
    got = spmm.spmm_compute_dtype()
    assert (got is None and want is None) or (got == torch.bfloat16 and want == jnp.bfloat16)


def test_compute_dtype_raises_on_other_values(monkeypatch):
    monkeypatch.setenv("NEUREC_SPMM_DTYPE", "fp16")
    for fn in (spmm.spmm_compute_dtype, jax_spmm._spmm_compute_dtype):
        with pytest.raises(ValueError, match="NEUREC_SPMM_DTYPE"):
            fn()


def _random_coo(seed, n_rows, n_src, nnz, empty_tail=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows - empty_tail, nnz).astype(np.int32)
    cols = rng.integers(0, n_src, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[: nnz // 20] = 0.0
    return rows, cols, vals


@pytest.mark.parametrize("tile,chunk", [("128", "64"), ("512", "512"), ("256", "512"), (None, "512")])
def test_plans_follow_the_geometry_variables(monkeypatch, tile, chunk):
    for name, value in (("NEUREC_SPMM_TILE", tile), ("NEUREC_SPMM_CHUNK", chunk)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    rows, cols, vals = _random_coo(3, 1500, 900, 9000, empty_tail=300)
    want = jax_spmm.build_spmm_plan(rows, cols, vals, 1500)
    got = spmm.build_spmm_plan(rows, cols, vals, 1500)
    assert (got.tile_r, got.rows.shape) == (want.tile_r, want.rows.shape)
    assert got.tile_r == int(tile or 256) and got.rows.shape[1] == int(chunk)
    for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)


def test_adjacency_plans_follow_the_geometry_variables(monkeypatch):
    monkeypatch.setenv("NEUREC_SPMM_TILE", "128")
    monkeypatch.setenv("NEUREC_SPMM_CHUNK", "512")
    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    want = jax_graph.build_norm_adjacency(ds.train_matrix, "norm")
    got = graph.build_norm_adjacency(ds.train_matrix, "norm", device="cpu")
    for plan, jplan in ((got.plan, want.plan), (got.plan_t, want.plan_t)):
        assert plan.tile_r == jplan.tile_r == 128 and plan.rows.shape[1] == 512
        for name in ("rows", "cols", "vals", "chunk_tile", "chunk_first"):
            np.testing.assert_array_equal(getattr(plan, name).numpy(), np.asarray(getattr(jplan, name)))


def test_self_loops_match_jax():
    ds = random_dataset(num_users=60, num_items=90, seed=3)
    for adj_type in ("gcmc", "pre"):
        want = jax_graph.build_norm_adjacency(ds.train_matrix, adj_type, self_loops=True)
        got = graph.build_norm_adjacency(ds.train_matrix, adj_type, self_loops=True, device="cpu")
        for name in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want.dense))


PLAN_CASES = [  # (n_rows, n_src, nnz, tile_r, chunk, empty_tail)
    (997, 773, 6000, 128, 128, 0),     # tail chunks, non-tile-multiple rows
    (1000, 700, 4000, 256, 256, 500),  # empty tiles at the end
    (512, 100, 300, 128, 64, 400),     # one populated tile
]


def _case(case, d, seed=1):
    n_rows, n_src, nnz, tile_r, chunk, empty_tail = case
    rows, cols, vals = _random_coo(seed, n_rows, n_src, nnz, empty_tail)
    x = np.random.default_rng(seed + 1).standard_normal((n_src, d)).astype(np.float32)
    jplan = jax_spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk)
    plan = spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk).to("cpu")
    return jplan, plan, x


def test_packed_layout_is_the_jax_parity_grouping():
    jplan, plan, _ = _case(PLAN_CASES[0], 8)
    for pack in (2, 4):
        rows_p, vals_p = spmm.packed_layout(plan, pack)
        n_chunks, chunk = jplan.rows.shape
        want_r = np.stack([jplan.rows[:, h::pack] for h in range(pack)], axis=1).reshape(n_chunks * pack, -1)
        want_v = np.stack([jplan.vals[:, h::pack] for h in range(pack)], axis=1).reshape(n_chunks * pack, -1)
        np.testing.assert_array_equal(rows_p.numpy(), want_r)
        np.testing.assert_array_equal(vals_p.numpy(), want_v)
        assert spmm.packed_layout(plan, pack)[0] is rows_p  # built once, kept with the plan
    assert plan.to("cpu").cache == {}  # a new placement starts its own cache


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_reference_matches_jax_interpret(case, pack, d, dtype):
    jplan, plan, x = _case(case, d)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    want = np.asarray(jax_spmm.plan_spmm_packed(jplan, jnp.asarray(x), pack, interpret=True, compute_dtype=jdt))
    xt = torch.from_numpy(x) if tdt is None else torch.from_numpy(x).to(tdt)
    got = spmm.plan_spmm_packed_reference(plan, xt, pack)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(spmm.plan_spmm_packed(plan, xt, pack).numpy(), got.numpy())


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("d", [32, 64])
def test_bf16_reference_matches_jax_interpret(case, d):
    jplan, plan, x = _case(case, d, seed=5)
    want = np.asarray(jax_spmm.plan_spmm(jplan, jnp.asarray(x), interpret=True, compute_dtype=jnp.bfloat16))
    got = spmm.plan_spmm_reference(plan, torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(spmm.plan_scatter(plan, torch.from_numpy(x).bfloat16()).numpy(), got.numpy())


def test_bf16_rounds_the_edge_values_too():
    """Rounding x alone, with f32 values, misses the JAX kernel beyond the
    tolerance: the TPU kernel's selector is cast to bf16."""
    jplan, plan, x = _case(PLAN_CASES[0], 64, seed=6)
    want = np.asarray(jax_spmm.plan_spmm(jplan, jnp.asarray(x), interpret=True, compute_dtype=jnp.bfloat16))
    xb = torch.from_numpy(x).bfloat16()
    dest = (plan.chunk_tile.long()[:, None] * plan.tile_r + plan.rows.long()).reshape(-1)
    contrib = xb[plan.cols.reshape(-1).long()].float() * plan.vals.reshape(-1, 1)  # f32 values
    unrounded = torch.zeros(plan.n_tiles * plan.tile_r, 64).index_add_(0, dest, contrib)[: plan.n_rows]
    assert not np.allclose(unrounded.numpy(), want, **TOL)
    np.testing.assert_allclose(spmm.plan_spmm_reference(plan, xb).numpy(), want, **TOL)


def test_plan_spmm_routes_by_pack_and_dtype(monkeypatch):
    _, plan, x = _case(PLAN_CASES[0], 64)
    calls = []
    real_packed, real_scatter = spmm.plan_spmm_packed, spmm.plan_scatter
    monkeypatch.setattr(spmm, "plan_spmm_packed",
                        lambda p, v, pack: calls.append(("packed", pack, v.dtype)) or real_packed(p, v, pack))
    monkeypatch.setattr(spmm, "plan_scatter", lambda p, v: calls.append(("scatter", v.dtype)) or real_scatter(p, v))
    xt = torch.from_numpy(x)
    monkeypatch.setenv("NEUREC_SPMM_PACK", "2")
    spmm.plan_spmm(plan, xt)
    spmm.plan_spmm(plan, xt.bfloat16())
    spmm.plan_spmm(plan, xt[:, :16].contiguous())  # d = 16: pack does not engage
    monkeypatch.setenv("NEUREC_SPMM_PACK", "auto")
    spmm.plan_spmm(plan, xt)
    assert calls == [("packed", 2, torch.float32), ("packed", 2, torch.bfloat16),
                     ("scatter", torch.float32), ("scatter", torch.float32)]


def _norm_plans(tile_r=32, chunk=16):
    ds = random_dataset(num_users=70, num_items=50, seed=8)
    adj = graph.build_norm_adjacency(ds.train_matrix, "norm", device="cpu")
    coo = (adj.rows.numpy(), adj.cols.numpy(), adj.vals.numpy())
    n = adj.n_nodes
    jplan = jax_spmm.build_spmm_plan(*coo, n, tile_r=tile_r, chunk=chunk)
    jplan_t = jax_spmm.build_spmm_plan(coo[1], coo[0], coo[2], n, tile_r=tile_r, chunk=chunk)
    plan = spmm.build_spmm_plan(*coo, n, tile_r=tile_r, chunk=chunk).to("cpu")
    plan_t = spmm.build_spmm_plan(coo[1], coo[0], coo[2], n, tile_r=tile_r, chunk=chunk)
    plan_adj = adj._replace(dense=None, plan=plan, plan_t=plan_t._replace(transposed=True).to("cpu"))
    return adj.dense.numpy(), plan_adj, jplan, jplan_t


@pytest.mark.parametrize("pack", ["1", "2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plan_spmm_gradient_matches_jax_vjp(monkeypatch, pack, dtype):
    """d/dx sum(g * (A @ x)) through ``PlanSpmm`` against ``jax.grad``
    through ``make_spmm`` (Pallas, interpret mode), both under
    ``NEUREC_SPMM_PACK`` and ``NEUREC_SPMM_DTYPE``; d = 64, where pack 2
    engages."""
    monkeypatch.setenv("NEUREC_SPMM_PACK", pack)
    monkeypatch.setenv("NEUREC_SPMM_DTYPE", dtype)
    dense, plan_adj, jplan, jplan_t = _norm_plans()
    assert not np.allclose(dense, dense.T)
    assert spmm.pack_factor(64, 16) == int(pack)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((dense.shape[0], 64)).astype(np.float32)
    g = rng.standard_normal((dense.shape[0], 64)).astype(np.float32)
    f = jax_spmm.make_spmm(jplan, jplan_t, interpret=True)  # compute dtype from the environment
    want_y = np.asarray(f(jnp.asarray(x)))
    want = np.asarray(jax.grad(lambda v: jnp.sum(f(v) * jnp.asarray(g)))(jnp.asarray(x)))

    seen = []
    real = spmm.plan_spmm

    def spy(plan, v):
        seen.append((plan.transposed, v.dtype))
        return real(plan, v)

    monkeypatch.setattr(spmm, "plan_spmm", spy)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = graph.spmm(plan_adj, xt)
    np.testing.assert_allclose(out.detach().numpy(), want_y, **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert seen == [(False, cast), (True, cast)]
    if dtype == "f32":
        np.testing.assert_allclose(xt.grad.numpy(), dense.T @ g, **TOL)
