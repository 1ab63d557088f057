"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor neurec_tpu, so it also runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Tolerance: atol/rtol 1e-5 — both sides compute in f32, with another
summation order (K1 in f32 FMAs up to d = 40, above on the tensor cores
through a 3xTF32 split). K1's f32 path is also held bit for bit to the
fmaf chain a thread a score (``k1.fma_chain_scores``). At d = 256
with randn factors no two f32 orders agree to 1e-5, so there K1 is held to
be no farther from the f64 product than the plain f32 product is.
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


def _finite_err(got, exact):
    finite = torch.isfinite(got)
    return float((got.double() - exact)[finite].abs().max())


def test_masked_scores_kernel_at_d256_no_farther_from_f64_than_f32(cuda):
    """At d = 256 with randn factors no two f32 summation orders agree to
    1e-5; the kernel's 3xTF32 product must be no farther from the f64
    product than the plain f32 one is, in both mask modes."""
    B, I, d = 2048, 38546, 256
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(9, B, I, d, 64))
    exact = u.double() @ items.double().T
    width = global_bits_width(I)
    bits = k1.pack_train_bits(rows, I, block_items=width)
    for got, want in ((k1.masked_scores(u, items, rows), k1.masked_scores_reference(u, items, rows)),
                      (k1.masked_scores_bits(u, items, bits, width, I),
                       k1.masked_scores_bits_reference(u, items, bits, width, I))):
        assert torch.equal(torch.isinf(got), torch.isinf(want)) and not torch.isnan(got).any()
        assert _finite_err(got, exact) <= _finite_err(want, exact)


def _check_both_modes(u, items, rows, width=None):
    """Both entry points against their plain versions (1e-5, -inf at the
    same places) and the same bits on a second call."""
    I = items.shape[0]
    width = global_bits_width(I) if width is None else width
    bits = k1.pack_train_bits(rows, I, block_items=width)
    runs = (
        (lambda: k1.masked_scores(u, items, rows), k1.masked_scores_reference(u, items, rows)),
        (lambda: k1.masked_scores_bits(u, items, bits, width, I),
         k1.masked_scores_bits_reference(u, items, bits, width, I)),
    )
    for run, want in runs:
        got = run()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        assert torch.equal(got, run())


@pytest.mark.parametrize("B,I", [(1, 130), (65, 129), (129, 65), (130, 1), (130, 130)])
@pytest.mark.parametrize("d", [4, 20, 33])
def test_masked_scores_kernel_ragged_shapes(cuda, B, I, d):
    """B and I not multiples of the 128 x 128 tile, d not a multiple of the
    32-deep slab (33: 4-byte copies)."""
    _check_both_modes(*(torch.from_numpy(a).to(cuda) for a in _scores_inputs(B * I + d, B, I, d, 40)))


@pytest.mark.parametrize("I,width", [(1000, 1000), (3000, 3008), (65, 72), (700, 2048)])
def test_masked_scores_bits_tiles_straddling_planes(cuda, I, width):
    """W a multiple of 8 but not of 1024: item tiles straddle bit planes
    (W/8 = 125, 376 and 9 bytes), and a W far above I."""
    _check_both_modes(*(torch.from_numpy(a).to(cuda) for a in _scores_inputs(I, 300, I, 64, 80)), width=width)


def test_masked_scores_all_masked_and_unmasked_rows(cuda):
    B, I, d = 140, 300, 64
    u, items, rows = _scores_inputs(3, B, I, d, I)
    rows[0] = np.arange(I)            # every item masked
    rows[1] = I                       # none
    rows[2, ::2] = np.arange(0, I, 2)[: (I + 1) // 2]
    rows = torch.from_numpy(rows).to(cuda)
    _check_both_modes(torch.from_numpy(u).to(cuda), torch.from_numpy(items).to(cuda), rows)
    got = k1.masked_scores(torch.from_numpy(u).to(cuda), torch.from_numpy(items).to(cuda), rows)
    assert torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()


def test_masked_scores_misaligned_operands_take_4_byte_copies(cuda):
    """d % 4 == 0 but u and items 4 bytes off a 16-byte boundary: the
    cp.async path, which gives the TMA path's bits on the same values."""
    B, I, d = 300, 1000, 64
    u, items, rows = _scores_inputs(6, B, I, d, 50)
    u_buf = torch.empty(B * d + 1, device=cuda)
    i_buf = torch.empty(I * d + 1, device=cuda)
    u_off = u_buf[1:].view(B, d).copy_(torch.from_numpy(u))
    i_off = i_buf[1:].view(I, d).copy_(torch.from_numpy(items))
    assert u_off.data_ptr() % 16 and i_off.data_ptr() % 16
    rows = torch.from_numpy(rows).to(cuda)
    _check_both_modes(u_off, i_off, rows)
    assert torch.equal(k1.masked_scores(u_off, i_off, rows),
                       k1.masked_scores(u_off.clone(), i_off.clone(), rows))


def test_masked_scores_non_finite_factors(cuda):
    """A NaN factor gives NaN scores and an inf factor non-finite ones (NaN
    where the plain product may give +-inf: the lo part of an inf is
    inf - inf); masked items stay -inf and the other rows hold 1e-5."""
    B, I, d = 8, 300, 64
    u, items, rows = _scores_inputs(12, B, I, d, 30)
    u[0, 3], u[1, 5] = np.nan, np.inf
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in (u, items, rows))
    width = global_bits_width(I)
    bits = k1.pack_train_bits(rows, I, block_items=width)
    marked = k1.build_train_mask(rows, I) != 0
    want = k1.masked_scores_reference(u, items, rows)
    for got in (k1.masked_scores(u, items, rows), k1.masked_scores_bits(u, items, bits, width, I)):
        assert (got[marked] == float("-inf")).all()
        assert torch.isnan(got[0][~marked[0]]).all()
        assert not torch.isfinite(got[1][~marked[1]]).any()
        torch.testing.assert_close(got[2:], want[2:], rtol=1e-5, atol=1e-5)


def test_round_tf32_kernel_is_the_cpu_rounding(cuda):
    """The card's cvt.rna.tf32.f32 against round_tf32_reference, bit for
    bit on every value but NaN, on edge values and random bit patterns. The
    instruction clears a NaN's low 13 payload bits (a NaN with no other
    payload becomes inf); K1 and the helper keep every NaN."""
    edges = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 2.0 ** -149, 2.0 ** -137, -(2.0 ** -137),
                      2.0 ** -126 - 2.0 ** -149, 0.0, -0.0, 3.4028234663852886e38, -3.4028234663852886e38,
                      np.inf, -np.inf, np.nan], dtype=np.float32)
    rand = np.random.RandomState(0).randint(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(np.concatenate([edges, rand.view(np.float32)]))
    got = k1.round_tf32(x.to(cuda)).cpu()
    want = k1.round_tf32_reference(x)
    nan = torch.isnan(x)
    assert torch.isnan(want[nan]).all()
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


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
    with pytest.raises(ValueError, match="even d"):
        spmm.plan_scatter(plan, torch.zeros(50, 7, dtype=torch.bfloat16, device=cuda))
    u = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        k1.masked_scores_bits(u, torch.zeros(10, 8, device=cuda),
                              torch.zeros(4, 128, dtype=torch.uint8), 1024, 10)


PACKED_CASES = [  # (n_rows, n_src, nnz, tile_r, chunk, empty_tail)
    (997, 773, 6000, 128, 128, 0),
    (1000, 700, 4000, 256, 512, 500),
    (512, 100, 300, 512, 64, 400),
]


@pytest.mark.parametrize("case", PACKED_CASES)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_plan_spmm_bf16_kernel_matches_reference(cuda, case, d):
    """K2 with bf16 features (edge values rounded to bf16, f32 sums) against
    its plain version fed the same bf16 inputs."""
    plan = _random_plan(3, *case).to(cuda)
    x = torch.randn(case[1], d, generator=torch.Generator().manual_seed(1)).to(cuda).bfloat16()
    got = spmm.plan_scatter(plan, x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, spmm.plan_spmm_reference(plan, x), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, spmm.plan_scatter(plan, x))


@pytest.mark.parametrize("case", PACKED_CASES)
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_spmm_packed_kernel_matches_reference(cuda, case, pack, d, dtype):
    """K3 against its plain version; its sum order is K2's, so the two
    kernels give the same bits over the same plan."""
    plan = _random_plan(5, *case).to(cuda)
    x = torch.randn(case[1], d, generator=torch.Generator().manual_seed(2)).to(cuda).to(dtype)
    before = dict(_build.LAUNCHES)
    got = spmm.plan_spmm_packed(plan, x, pack)
    torch.testing.assert_close(got, spmm.plan_spmm_packed_reference(plan, x, pack), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, spmm.plan_spmm_packed(plan, x, pack))
    assert torch.equal(got, spmm.plan_scatter(plan, x))
    assert _build.LAUNCHES["plan_spmm_packed"] == before["plan_spmm_packed"] + 2


def test_plan_spmm_packed_backward_over_the_transposed_plan(cuda, monkeypatch):
    """Under NEUREC_SPMM_PACK=2 both directions of PlanSpmm run K3 (the
    backward over the ``norm`` plan_t, counted as plan_spmm_packed_t)."""
    from neurec_tpu_torch.data.synthetic import random_dataset
    from neurec_tpu_torch.ops import graph

    monkeypatch.setenv("NEUREC_SPMM_PACK", "2")
    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    adj = graph.build_norm_adjacency(ds.train_matrix, "norm", device=cuda)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(adj.n_nodes, 64, generator=gen).to(cuda).requires_grad_(True)
    g = torch.randn(adj.n_nodes, 64, generator=gen).to(cuda)
    before = dict(_build.LAUNCHES)
    out = graph.spmm(adj, x)
    (out * g).sum().backward()
    torch.testing.assert_close(out, spmm.plan_spmm_reference(adj.plan, x.detach()), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x.grad, spmm.plan_spmm_reference(adj.plan_t, g), atol=1e-5, rtol=1e-5)
    assert _build.LAUNCHES["plan_spmm_packed"] == before["plan_spmm_packed"] + 1
    assert _build.LAUNCHES["plan_spmm_packed_t"] == before["plan_spmm_packed_t"] + 1
    assert _build.LAUNCHES["plan_spmm"] == before["plan_spmm"]


def _hub_coo(seed, n=5000, hub_degree=1500):
    """A square power-law graph: Zipf row degrees (capped at 200) and one
    hub row of ``hub_degree`` edges, longer than many spans. Values
    N(0, 1/degree), as a normalized adjacency scales a hub's, so that every
    row's sum is O(1) and f32 noise stays below the tolerance."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, n), 200)
    deg[n // 3] = hub_degree
    rows = np.repeat(np.arange(n), deg).astype(np.int32)
    cols = rng.integers(0, n, rows.size).astype(np.int32)
    vals = (rng.standard_normal(rows.size) / np.sqrt(deg[rows])).astype(np.float32)
    return rows, cols, vals, n


@pytest.mark.parametrize("graph", ["hub", "tile1024"])
@pytest.mark.parametrize("direction", ["plan", "plan_t"])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_kernels_on_hub_rows_and_wide_tiles(cuda, monkeypatch, graph, direction, d, dtype):
    """K2 and K3 (pack 2 and 4) over the plan and the transposed plan of a
    graph with a hub row cut across spans, and of a NEUREC_SPMM_TILE=1024
    plan (no tile limit): each against its plain version, the same bits
    twice, and K3 == K2 bit for bit."""
    if graph == "tile1024":
        monkeypatch.setenv("NEUREC_SPMM_TILE", "1024")
    rows, cols, vals, n = _hub_coo(11)
    if direction == "plan_t":
        rows, cols = cols, rows
    plan = spmm.build_spmm_plan(rows, cols, vals, n)._replace(transposed=direction == "plan_t").to(cuda)
    assert plan.tile_r == (1024 if graph == "tile1024" else 256)
    if direction == "plan":
        assert spmm.spmm_schedule(plan).split.shape[0] > 0  # the hub row is cut
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(d)).to(cuda).to(dtype)
    k2 = spmm.plan_scatter(plan, x)
    torch.testing.assert_close(k2, spmm.plan_spmm_reference(plan, x), atol=1e-5, rtol=1e-5)
    assert torch.equal(k2, spmm.plan_scatter(plan, x))
    for pack in (2, 4):
        k3 = spmm.plan_spmm_packed(plan, x, pack)
        torch.testing.assert_close(k3, spmm.plan_spmm_packed_reference(plan, x, pack), atol=1e-5, rtol=1e-5)
        assert torch.equal(k3, spmm.plan_spmm_packed(plan, x, pack))
        assert torch.equal(k3, k2)


def test_plan_kernels_give_every_chunk_the_same_bits(cuda):
    """The schedule does not depend on the chunk: K2 over a chunk-256 plan
    and K3 over a chunk-512 plan of one graph give the same bits."""
    rows, cols, vals, n = _hub_coo(12)
    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(3)).to(cuda)
    p256 = spmm.build_spmm_plan(rows, cols, vals, n, chunk=256).to(cuda)
    p512 = spmm.build_spmm_plan(rows, cols, vals, n, chunk=512).to(cuda)
    assert torch.equal(spmm.plan_scatter(p256, x), spmm.plan_spmm_packed(p512, x, 2))


@pytest.mark.parametrize("mode", ["serial", "pipelined"])
@pytest.mark.parametrize("rows", [1, 4, 16])
def test_dma_rate_kernel_writes_the_plain_versions_rows(cuda, mode, rows):
    from neurec_tpu_torch.benchmarks import dma_rate

    offs = torch.from_numpy(np.random.RandomState(rows).randint(0, dma_rate.OUT_ROWS - rows, 5000)
                            .astype(np.int32)).to(cuda)
    for n_dma in (1, 4999, 12345):
        got = dma_rate.dma_copies(offs, n_dma, rows, mode, dma_rate.new_buffer(cuda))
        assert torch.equal(got, dma_rate.dma_copies_reference(offs, n_dma, rows))


def _check_f32_path_bits(u, items, rows, width=None):
    """K1's f32 path in both mask modes, bit for bit against the fmaf chain
    a thread a score (``k1.fma_chain_scores``) with -inf where the plain
    version has it; the same bits on a second call; every finite score
    within d 2^-24 sum_k |u_k i_k| of the f64 product."""
    I, d = items.shape
    assert k1.k1_path(d) == "fma"
    width = global_bits_width(I) if width is None else width
    bits = k1.pack_train_bits(rows, I, block_items=width)
    chain = k1.fma_chain_scores(u, items)
    exact = u.double() @ items.double().T
    bound = d * 2.0 ** -24 * (u.double().abs() @ items.double().abs().T)
    runs = (
        (lambda: k1.masked_scores(u, items, rows), k1.masked_scores_reference(u, items, rows)),
        (lambda: k1.masked_scores_bits(u, items, bits, width, I),
         k1.masked_scores_bits_reference(u, items, bits, width, I)),
    )
    for run, want in runs:
        got = run()
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        oracle = torch.where(torch.isneginf(want), float("-inf"), chain)
        assert torch.equal(got.view(torch.int32), oracle.view(torch.int32))
        assert torch.equal(got.view(torch.int32), run().view(torch.int32))
        finite = torch.isfinite(got)
        assert bool(((got.double() - exact).abs() <= bound)[finite].all())


@pytest.mark.parametrize("d", [1, 2, 3, 16, 17, 21, 33, 40, 41, 64, 65])
def test_masked_scores_kernel_at_the_factorized_models_widths(cuda, d):
    """K1 at the evaluation shape and the widths the models give it (Pop 1,
    WRMF 16, FISM 17, IRGAN 21, MultiDAE and MultiVAE 33, APR 64, CDAE 65,
    the f32 path's edges 40 and 41, and d 2 and 3, whose runs are shorter
    than a 16-byte copy a row), bits and int8 masks, against its plain
    version. Where the f32 path runs (d <= 40) each score is the fmaf chain
    a thread a score bit for bit, and within d 2^-24 sum_k |u_k i_k| of the
    f64 product."""
    B, I = 2048, 38546
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(21 + d, B, I, d, 64))
    _check_both_modes(u, items, rows)
    if k1.k1_path(d) == "fma":
        _check_f32_path_bits(u, items, rows)


F32_PATH_WIDTHS = [1, 2, 3, 16, 17, 21, 33, 40]
# every (B, I) of B in {1, 127, 129, 2048} and I in {1, 127, 129, 700, 3706,
# 38546} but (2048, 38546), which the factorized models' widths test runs
F32_PATH_SHAPES = [(B, I) for B in (1, 127, 129, 2048) for I in (1, 127, 129, 700, 3706, 38546)
                   if (B, I) != (2048, 38546)]


@pytest.mark.parametrize("B,I", F32_PATH_SHAPES)
@pytest.mark.parametrize("d", F32_PATH_WIDTHS)
def test_masked_scores_f32_path_bits_across_shapes(cuda, d, B, I):
    """The f32 path's persistent row-band schedule at the shapes it can get
    wrong: one user or item, a ragged last tile either way (127, 129),
    serving's and ml-1m's and gowalla's catalogues (a band of 6, 29 or 302
    item tiles), at every width class (runs of whole and ragged 16-byte
    copies): the chain's bits in both masks."""
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(B + I + d, B, I, d, 40))
    _check_f32_path_bits(u, items, rows)


@pytest.mark.parametrize("d", F32_PATH_WIDTHS)
def test_masked_scores_f32_path_bits_on_straddling_planes_and_unaligned_bases(cuda, d):
    """The f32 path off the evaluator's layouts: bit planes of W/8 = 376
    bytes (W 3,008, not a multiple of 1024: tiles straddle two planes) and
    of 375 (W 3,000: 8-byte mask copies do not apply, the marks are read
    from global memory), and u and items one float off a 16-byte boundary
    (4-byte copies of the runs); each against the chain's bits, and the
    unaligned call equal to the aligned one."""
    B, I = 300, 3000
    u, items, rows = _scores_inputs(d, B, I, d, 80)
    rows = torch.from_numpy(rows).to(cuda)
    u_a, i_a = torch.from_numpy(u).to(cuda), torch.from_numpy(items).to(cuda)
    _check_f32_path_bits(u_a, i_a, rows, width=3008)
    _check_f32_path_bits(u_a, i_a, rows, width=3000)
    u_buf = torch.empty(B * d + 1, device=cuda)
    i_buf = torch.empty(I * d + 1, device=cuda)
    u_off = u_buf[1:].view(B, d).copy_(u_a)
    i_off = i_buf[1:].view(I, d).copy_(i_a)
    assert not k1.aligned16(u_off, i_a) and not k1.aligned16(u_a, i_off) and k1.aligned16(u_a, i_a)
    for uu, ii in ((u_off, i_a), (u_a, i_off), (u_off, i_off)):
        _check_f32_path_bits(uu, ii, rows)
        _check_f32_path_bits(uu, ii, rows, width=3008)
        assert torch.equal(k1.masked_scores(uu, ii, rows).view(torch.int32),
                           k1.masked_scores(u_a, i_a, rows).view(torch.int32))


def test_fma_chain_kernel_is_the_cpu_chain(cuda):
    """The card's chain a thread a score against its plain version (the
    chain emulated in f64) on the CPU, bit for bit at a small shape, and
    on the case where one fmaf differs from a product and a sum."""
    u, items, _ = _scores_inputs(5, 64, 300, 21, 1)
    u, items = torch.from_numpy(u), torch.from_numpy(items)
    got = k1.fma_chain_scores(u.to(cuda), items.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32), k1.fma_chain_scores_reference(u, items).view(torch.int32))
    x = 1 + 2.0 ** -12  # x * x = 1 + 2^-11 + 2^-24: rounded alone, its last bit is lost
    u1, i1 = torch.tensor([[-1.0, x]], device=cuda), torch.tensor([[1.0, x]], device=cuda)
    assert float(k1.fma_chain_scores(u1, i1)) == 2.0 ** -11 + 2.0 ** -24


def _stable_sort_topk(x, k):
    values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], ids[:, :k]


@pytest.mark.parametrize("k", [1, 20, 700])
def test_top_k_on_the_card_matches_the_stable_sort(cuda, k):
    """``top_k`` (``torch.topk`` and a tie fix-up) gives the stable sort's
    ids and values at the evaluation shape: masked -inf items, rows with
    ties forced across the K-th place, rows of one value."""
    from neurec_tpu_torch.ops.topk import top_k

    g = torch.Generator(device=cuda).manual_seed(k)
    B, I = 2048, 38546
    x = torch.randn(B, I, generator=g, device=cuda)
    x[torch.rand(B, I, generator=g, device=cuda) < 0.01] = float("-inf")
    kth = torch.sort(x[:64], dim=-1, descending=True)[0][:, k - 1 : k]
    x[:64] = torch.where((x[:64] - kth).abs() < 0.05, kth, x[:64])  # ties across the K-th place
    x[64:72] = 0.5
    x[72:80] = float("-inf")
    x[80:88] = torch.randint(0, 3, (8, I), generator=g, device=cuda).float()
    got_v, got_i = top_k(x, k)
    want_v, want_i = _stable_sort_topk(x, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v, want_v)


@pytest.mark.parametrize("d", [16, 17, 32, 50, 64, 100, 101])
def test_masked_scores_kernel_at_the_sequential_models_widths(cuda, d):
    """K1 at the sequential models' evaluation shape (ml-1m: 3,706 items,
    eval batch 2048) and widths (HRM 16, Fossil 17, FPMC 32, SASRec 50, NPE
    64, Caser 100, GRU4Rec and GRU4RecPlus 101: f32 FMAs at 16, 17 and 32,
    there the fmaf chain's bits,
    the split's cp.async path at the ragged 50 and 101, its TMA path at 64
    and 100), both masks: -inf where the plain version has it, the same bits
    twice, and every score within the bound of the path it takes from the
    f64 product, d 2^-24 sum_k |u_k i_k| on the f32 path and
    (3 2^-22 + d 2^-24) sum_k |u_k i_k| on the split. Up to d 64 the scores
    are also within 1e-5 of the plain f32 product; at d 100 and 101 on randn
    factors two f32 orders differ by more (1.3e-5 at d 101: the plain
    product's own rounding), so there, as at d 256, K1 is held to be no
    farther from the f64 product than the plain product or within its
    path's bound."""
    B, I = 2048, 3706
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(50 + d, B, I, d, 64))
    if d <= 64:
        _check_both_modes(u, items, rows)
    if k1.k1_path(d) == "fma":
        _check_f32_path_bits(u, items, rows)
    rel = d * 2.0 ** -24 + (0.0 if k1.k1_path(d) == "fma" else 3 * 2.0 ** -22)
    exact = u.double() @ items.double().T
    bound = rel * (u.double().abs() @ items.double().abs().T)
    width = global_bits_width(I)
    bits = k1.pack_train_bits(rows, I, block_items=width)
    for run, want in ((lambda: k1.masked_scores(u, items, rows), k1.masked_scores_reference(u, items, rows)),
                      (lambda: k1.masked_scores_bits(u, items, bits, width, I),
                       k1.masked_scores_bits_reference(u, items, bits, width, I))):
        got = run()
        finite = torch.isfinite(got)
        assert torch.equal(torch.isinf(got), torch.isinf(want)) and torch.equal(got, run())
        assert bool(((got.double() - exact).abs() <= bound)[finite].all())


@pytest.mark.parametrize("I,B", [(38546, 2048), (700, 16)])
def test_masked_scores_on_a_streamed_bit_plane_equals_the_tables(cuda, I, B):
    """The streamed tier's device pack (``tiers.make_edge_pack``, from the
    batch's (item, slot) edges) feeds K1 the table's planes: K1's scores are
    bit-equal to K1 on the resident table's rows (d 16, SBPR's and
    DiffNet's width, at gowalla's evaluation shape and a small one)."""
    from neurec_tpu_torch.eval.tiers import make_edge_pack

    u, items, rows = _scores_inputs(16, B, I, 16, 96)
    width = global_bits_width(I)
    table = k1.pack_train_bits(torch.from_numpy(rows).to(cuda), I, block_items=width)
    slots, its = np.nonzero(rows < I)
    pad = (-len(its)) % 8
    e_items = torch.from_numpy(np.r_[rows[slots, its], np.zeros(pad, np.int32)]).long().to(cuda)
    e_slots = torch.from_numpy(np.r_[slots, np.full(pad, B)]).long().to(cuda)
    streamed = make_edge_pack(width, width)(e_items, e_slots, B)
    assert streamed.shape == table.shape and streamed.dtype == torch.uint8
    u, items = torch.from_numpy(u).to(cuda), torch.from_numpy(items).to(cuda)
    before = _build.LAUNCHES["masked_scores"]
    got = k1.masked_scores_bits(u, items, streamed, width, I)
    assert torch.equal(got, k1.masked_scores_bits(u, items, table, width, I))
    assert _build.LAUNCHES["masked_scores"] == before + 2


@pytest.mark.parametrize("k,kw", [(20, {}), (50, {}), (20, dict(seg=128, max_hot=2))])
def test_exact_topk_indices_on_the_card_matches_top_k(cuda, k, kw):
    """``ops/fast_topk.py`` on K1's masked scores at gowalla's shape: the ids
    of ``top_k`` wherever the overflow is 0, computed on the card."""
    from neurec_tpu_torch.ops.fast_topk import exact_topk_indices
    from neurec_tpu_torch.ops.topk import top_k

    B, I, d = 512, 38546, 64
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(11, B, I, d, 32))
    x = k1.masked_scores(u, items, rows)
    x[:, 100:140] = x[:, :1]  # ties across the K-th place
    idx, overflow = exact_topk_indices(x, k, **kw)
    assert idx.device.type == "cuda" and overflow.device.type == "cuda"
    want = top_k(x, k)[1]
    if kw:
        assert int(overflow) > 0
    else:
        assert int(overflow) == 0
        assert torch.equal(idx.long(), want)


def test_native_evaluation_of_scores_from_the_card(cuda):
    """``eval_backend=native`` on scores computed on the card: the metric
    strings of the device backend (its predict tier, on the same scores)
    within 1e-5."""
    from neurec_tpu_torch.eval.evaluator import UniEvaluator

    rng = np.random.RandomState(12)
    U, I, d = 300, 2000, 64
    train = {u: sorted(rng.choice(I, 20, replace=False).tolist()) for u in range(U)}
    test = {u: sorted(set(rng.choice(I, 5, replace=False).tolist()) - set(train[u])) or [0] for u in range(U)}
    u_emb = torch.from_numpy(rng.randn(U, d).astype(np.float32)).to(cuda)
    i_emb = torch.from_numpy(rng.randn(I, d).astype(np.float32)).to(cuda)

    def predict(p, users):
        return u_emb[users] @ i_emb.T

    args = dict(metric=["Precision", "Recall", "NDCG"], top_k=[5, 20], batch_size=128, num_items=I)
    got = UniEvaluator(train, test, backend="native", num_thread=4, **args).evaluate(predict, None)
    want = UniEvaluator(train, test, **args).evaluate(predict, None)
    for a, b in zip(got.split("\t"), want.split("\t")):
        assert abs(float(a) - float(b)) <= 1e-5, (got, want)


# -- the mesh paths' shapes: a per-block bits table, a block plan -------------

@pytest.mark.parametrize("block", [0, 1])
def test_masked_scores_on_a_per_block_bits_table(cuda, block):
    """K1 as the item-sharded tier runs it: I_m = 19,456 items of a 38,546
    catalogue on two 'model' ranks (``shard_bits_geometry``), the rank's own
    contiguous (B, I_m/8) bits table packed per block, the item block zero
    past the catalogue; the masked columns are the block's train ids less
    the block's start."""
    from neurec_tpu_torch.eval.tiers import _item_block, shard_bits_geometry

    I = 38546
    I_m, width = shard_bits_geometry(I, 2)
    assert I_m == 19456
    u, items, rows = (torch.from_numpy(a).to(cuda) for a in _scores_inputs(9, 2048, I, 64, 64))
    bits = k1.pack_train_bits(rows, I, block_items=I_m)[:, block * I_m // 8: (block + 1) * I_m // 8].contiguous()
    off = block * I_m
    item_block = _item_block(items, off, I_m)
    before = _build.LAUNCHES["masked_scores"]
    got = k1.masked_scores_bits(u, item_block, bits, I_m, I_m)
    assert _build.LAUNCHES["masked_scores"] == before + 1
    want = k1.masked_scores_bits_reference(u, item_block, bits, I_m, I_m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    masked = torch.zeros((2048, I_m), dtype=torch.bool, device=cuda)
    local = rows.long() - off
    inside = (local >= 0) & (local < I_m)
    masked[torch.arange(2048, device=cuda)[:, None].expand_as(local)[inside], local[inside]] = True
    assert torch.equal(torch.isinf(got), masked)


@pytest.mark.parametrize("index", [0, 1])
def test_plan_spmm_on_a_block_plan_and_its_transpose(cuda, index):
    """K2 and K2 backward on one 'data' rank's block of a graph above
    DENSE_LIMIT (``shard_adjacency``): block-local destination rows and
    global source columns, and the transposed plan with n_nodes rows."""
    import types

    from neurec_tpu_torch.data.synthetic import random_dataset
    from neurec_tpu_torch.ops import graph

    ds = random_dataset(num_users=6000, num_items=3000, seed=4)
    adj = graph.build_norm_adjacency(ds.train_matrix, "pre", device=cuda)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, coordinate={"data": index, "model": 0})
    block = graph.shard_adjacency(adj, mesh)
    assert block.plan.n_rows == block.block == -(-adj.n_nodes // 2) and block.plan_t.n_rows == adj.n_nodes
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(adj.n_nodes, 64, generator=gen).to(cuda)
    g = torch.randn(block.block, 64, generator=gen).to(cuda)
    before = dict(_build.LAUNCHES)
    got = spmm.plan_spmm(block.plan, x)
    torch.testing.assert_close(got, spmm.plan_spmm_reference(block.plan, x), atol=1e-5, rtol=1e-5)
    # the block's rows of the whole graph's A @ x
    lo = index * block.block
    torch.testing.assert_close(got[: adj.n_nodes - lo], spmm.plan_spmm_reference(adj.plan, x)[lo: lo + block.block],
                               atol=1e-5, rtol=1e-5)
    got_t = spmm.plan_spmm(block.plan_t, g)
    torch.testing.assert_close(got_t, spmm.plan_spmm_reference(block.plan_t, g), atol=1e-5, rtol=1e-5)
    assert _build.LAUNCHES["plan_spmm"] == before["plan_spmm"] + 1
    assert _build.LAUNCHES["plan_spmm_t"] == before["plan_spmm_t"] + 1
