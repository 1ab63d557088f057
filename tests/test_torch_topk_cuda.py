"""The top-K kernel (``csrc/topk.cu``) against its plain version on the CPU,
on a card: ids equal and values equal bit for bit.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither jax nor neurec_tpu:

    python -m pytest tests/test_torch_topk_cuda.py -m cuda --noconftest -q

Each block mixes the rows the order has to get right: random scores with a
share of -inf (masked items), small integers (ties across the K-th place),
one value, all -inf, NaN of both signs among signed zeros, random scores
with the values around the K-th forced equal, and scores of a narrow spread
(every key's top bits the same). Shapes: k = 1, 20, 50 and I; I = 7, 57,
3,706 (ml-1m), 38,546 (gowalla), 91,599 (Amazon-Book); B = 1, 485 and
2,048. The streamed path is held to the resident one's answer on rows that
fit shared memory, the path is checked at the longest resident row, rows
that lie apart and start off 16 bytes too, a capture in a CUDA graph
replayed on new scores, and the launch counts by path.
"""

import os
import re

import numpy as np
import pytest
import torch

from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda

# the longest row the kernel keeps in shared memory, read from its source
with open(os.path.join(_build.CSRC_DIR, "topk.cu")) as _src:
    RESIDENT_MAX_ITEMS = int(re.search(r"RESIDENT_MAX_ITEMS = (\d+);", _src.read()).group(1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _neg_nan():
    return (np.array([np.nan], np.float32).view(np.uint32) | np.uint32(0x80000000)).view(np.float32)[0]


def scores(seed, B, I, k):
    """(B, I) float32 rows of the kinds in the module docstring, in turn."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, I)).astype(np.float32)
    x[rng.rand(B, I) < 0.05] = -np.inf
    for r in range(B):
        kind = r % 7
        if kind == 1:
            x[r] = rng.randint(-3, 4, I)
        elif kind == 2:
            x[r] = 0.25
        elif kind == 3:
            x[r] = -np.inf
        elif kind == 4:
            x[r] = rng.choice(np.array([0.0, -0.0, np.nan, _neg_nan(), 1.0, -np.inf], np.float32), I)
        elif kind == 5:
            kth = np.sort(x[r])[::-1][k - 1]
            x[r, np.abs(x[r] - kth) < 0.3] = kth
        elif kind == 6:
            x[r] = 0.3 + 1e-4 * rng.standard_normal(I)
    return x


def check(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == torch.int64 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())
    np.testing.assert_array_equal(gv.cpu().numpy().view(np.int32), wv.numpy().view(np.int32))


CASES = [(B, I, k) for I in (7, 57, 3706, 38546, 91599) for B in (1, 485, 2048)
         for k in sorted({1, 20, 50, I}) if k <= I and not (k == I and B * I > 20_000_000)]


@pytest.mark.parametrize("B,I,k", CASES)
def test_kernel_matches_the_plain_version(cuda, B, I, k):
    x = scores(I + k + B, B, I, k)
    want = topk.top_k_reference(torch.from_numpy(x), k)
    xd = torch.from_numpy(x).to(cuda)
    before = dict(_build.LAUNCHES)
    got = topk.top_k(xd, k)
    torch.cuda.synchronize()
    check(got, want)
    path = "topk_" + ("resident" if I <= RESIDENT_MAX_ITEMS else "streamed")
    assert _build.LAUNCHES["topk"] == before["topk"] + 1
    assert _build.LAUNCHES[path] == before[path] + 1


@pytest.mark.parametrize("I", [7, 57, 1024, 1025, 3706, 38546])
@pytest.mark.parametrize("k", [1, 20, 300])
def test_every_path_gives_the_same_answer(cuda, I, k):
    k = min(k, I)
    x = scores(7 * I + k, 97, I, k)
    want = topk.top_k_reference(torch.from_numpy(x), k)
    xd = torch.from_numpy(x).to(cuda)
    for streamed in (False, True):
        vals = torch.empty((97, k), dtype=torch.float32, device=cuda)
        ids = torch.empty((97, k), dtype=torch.int64, device=cuda)
        assert topk._run(xd, k, vals, ids, streamed=streamed) == ("streamed" if streamed else "resident")
        check((vals, ids), want)


@pytest.mark.parametrize("I", [RESIDENT_MAX_ITEMS, RESIDENT_MAX_ITEMS + 1])
def test_the_longest_resident_row(cuda, I):
    """The kernel reports the path it took: the row in shared memory up to
    RESIDENT_MAX_ITEMS items, streamed from device memory above."""
    x = scores(I, 33, I, 20)
    xd = torch.from_numpy(x).to(cuda)
    vals = torch.empty((33, 20), dtype=torch.float32, device=cuda)
    ids = torch.empty((33, 20), dtype=torch.int64, device=cuda)
    assert topk._run(xd, 20, vals, ids) == ("resident" if I == RESIDENT_MAX_ITEMS else "streamed")
    check((vals, ids), topk.top_k_reference(torch.from_numpy(x), 20))


@pytest.mark.parametrize("I,k", [(57, 20), (3706, 20), (38546, 20), (38546, 2000)])
def test_rows_that_lie_apart_and_start_off_alignment(cuda, I, k):
    """A slice of a wider block (the scatter tier's ``ext[:, :I]``): each
    row starts one float further from a 16-byte boundary."""
    wide = scores(I + 1, 64, I + 1, k)
    want = topk.top_k_reference(torch.from_numpy(wide[:, :I]), k)
    xd = torch.from_numpy(wide).to(cuda)[:, :I]
    assert not xd.is_contiguous()
    check(topk.top_k(xd, k), want)
    tail = torch.from_numpy(wide).to(cuda)[:, 1:]  # every row starts 4 bytes in
    check(topk.top_k(tail, k), topk.top_k_reference(torch.from_numpy(wide[:, 1:]), k))


@pytest.mark.parametrize("I", [100, 38546])
def test_captured_in_a_graph_and_replayed(cuda, I):
    B, k = 512, 20
    static = torch.from_numpy(scores(1, B, I, k)).to(cuda)
    topk.top_k(static, k)  # warm: the library loads, the attributes are set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.captured_launches() as delta:
        with torch.cuda.graph(graph):
            vals, ids = topk.top_k(static, k)
    assert delta == {"topk": 1, "topk_resident": 1}
    for seed in (2, 3):
        x = scores(seed, B, I, k)
        static.copy_(torch.from_numpy(x))
        graph.replay()
        torch.cuda.synchronize()
        check((vals, ids), topk.top_k_reference(torch.from_numpy(x), k))


def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 50, device=cuda)
    with pytest.raises(TypeError):
        topk.top_k(x.bfloat16(), 5)
    with pytest.raises(ValueError):
        topk.top_k(x[None], 5)
    with pytest.raises(ValueError):
        topk.top_k(x.T, 2)
    with pytest.raises(ValueError):
        topk.top_k(x, 51)
