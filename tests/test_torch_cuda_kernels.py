"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor neurec_tpu, so it also runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Tolerance: atol/rtol 1e-5 — both sides compute in f32, with another
summation order.
"""

import numpy as np
import pytest
import torch

from neurec_tpu_torch.eval.tiers import global_bits_width
from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.ops import masked_scores as k1
from neurec_tpu_torch.ops import spmm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scores_inputs(seed, B, I, d, L):
    rng = np.random.RandomState(seed)
    u = rng.randn(B, d).astype(np.float32)
    items = rng.randn(I, d).astype(np.float32)
    rows = np.full((B, L), I, dtype=np.int32)
    for b in range(B):
        n = rng.randint(0, min(L, I) + 1)
        rows[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    return u, items, rows


@pytest.mark.parametrize("B,I,d", [(2048, 38546, 64), (70, 1000, 20), (1, 65, 8), (130, 129, 33)])
def test_masked_scores_kernel_matches_reference(cuda, B, I, d):
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(4, B, I, d, 64))
    before = _build.LAUNCHES["masked_scores"]
    got = k1.masked_scores(u, items, rows)
    torch.testing.assert_close(got, k1.masked_scores_reference(u, items, rows), rtol=1e-5, atol=1e-5)
    width = global_bits_width(I)
    bits = k1.pack_train_bits(rows, I, block_items=width)
    got = k1.masked_scores_bits(u, items, bits, width, I)
    want = k1.masked_scores_bits_reference(u, items, bits, width, I)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert _build.LAUNCHES["masked_scores"] == before + 2


def _random_plan(seed, n_rows, n_src, nnz, tile_r, chunk, empty_tail):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows - empty_tail, nnz).astype(np.int32)
    cols = rng.integers(0, n_src, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return spmm.build_spmm_plan(rows, cols, vals, n_rows, tile_r=tile_r, chunk=chunk)


@pytest.mark.parametrize("n_rows,n_src,nnz,tile_r,chunk,empty_tail", [
    (997, 773, 6000, 128, 128, 0),
    (1000, 700, 4000, 256, 256, 500),
    (512, 100, 300, 128, 64, 400),
    (300, 50, 0, 256, 256, 0),
])
@pytest.mark.parametrize("d", [8, 64, 100])
def test_plan_spmm_kernel_matches_reference(cuda, n_rows, n_src, nnz, tile_r, chunk, empty_tail, d):
    plan = _random_plan(7, n_rows, n_src, nnz, tile_r, chunk, empty_tail).to(cuda)
    x = torch.randn(n_src, d, generator=torch.Generator().manual_seed(0)).to(cuda)
    got = spmm.plan_spmm(plan, x)
    torch.testing.assert_close(got, spmm.plan_spmm_reference(plan, x), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, spmm.plan_spmm(plan, x))  # fixed sum order: same bits


@pytest.mark.parametrize("adj_type", ["gcmc", "norm"])
def test_plan_spmm_backward_over_the_transposed_plan(cuda, adj_type):
    """K2 over plan_t, and PlanSpmm's autograd backward, against the plain
    version on a non-symmetric adjacency above DENSE_LIMIT."""
    from neurec_tpu_torch.data.synthetic import random_dataset
    from neurec_tpu_torch.ops import graph

    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    adj = graph.build_norm_adjacency(ds.train_matrix, adj_type, device=cuda)
    assert adj.dense is None and adj.plan_t.transposed
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(adj.n_nodes, 64, generator=gen).to(cuda)
    before = dict(_build.LAUNCHES)
    got = spmm.plan_spmm(adj.plan_t, g)
    torch.testing.assert_close(got, spmm.plan_spmm_reference(adj.plan_t, g), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, spmm.plan_spmm(adj.plan_t, g))
    assert _build.LAUNCHES["plan_spmm_t"] == before["plan_spmm_t"] + 2
    assert _build.LAUNCHES["plan_spmm"] == before["plan_spmm"]

    x = torch.randn(adj.n_nodes, 64, generator=gen).to(cuda).requires_grad_(True)
    out = graph.spmm(adj, x)
    (out[: ds.num_users] * g[: ds.num_users]).sum().backward()  # a strided gradient
    g_in = torch.cat([g[: ds.num_users], torch.zeros_like(g[ds.num_users:])])
    torch.testing.assert_close(x.grad, spmm.plan_spmm_reference(adj.plan_t, g_in), atol=1e-5, rtol=1e-5)
    assert _build.LAUNCHES["plan_spmm_t"] == before["plan_spmm_t"] + 3


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    plan = _random_plan(1, 300, 50, 100, 256, 256, 0).to(cuda)
    with pytest.raises(TypeError):
        spmm.plan_spmm(plan, torch.zeros(50, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        spmm.plan_spmm(plan, torch.zeros(50, 8))  # x on the cpu, plan on the card
    u = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        k1.masked_scores_bits(u, torch.zeros(10, 8, device=cuda),
                              torch.zeros(4, 128, dtype=torch.uint8), 1024, 10)
