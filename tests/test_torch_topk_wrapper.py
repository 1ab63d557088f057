"""``ops/topk.py``'s wrapper around the top-K kernel, on the CPU, with the
launch stubbed (as tests/test_torch_eval_graph.py stubs the CUDA side): the
checks that refuse what the kernel does not take, the launch counts by the
path the kernel reports, the arguments the kernel is handed, and that a CPU
tensor takes the plain version and never the kernel."""

import numpy as np
import pytest
import torch

from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.ops import topk


@pytest.fixture
def launches(monkeypatch):
    """The kernel's launch replaced by the plain version, which reports the
    path ``calls.path`` (the resident one unless a test sets it); yields the
    calls' (x, k, streamed)."""

    class Calls(list):
        path = "resident"

    calls = Calls()

    def run(x, k, vals, ids, streamed=False):
        calls.append((x, k, streamed))
        v, i = topk.top_k_reference(x, k)
        vals.copy_(v)
        ids.copy_(i)
        return calls.path

    monkeypatch.setattr(topk, "_run", run)
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64, torch.int32])
def test_refuses_other_dtypes(launches, dtype):
    with pytest.raises(TypeError):
        topk.top_k_kernel(torch.zeros(3, 10).to(dtype), 2)
    assert not launches


@pytest.mark.parametrize("shape", [(), (10,), (2, 3, 10), (1, 1, 1, 10)])
def test_refuses_other_ranks(launches, shape):
    with pytest.raises(ValueError):
        topk.top_k_kernel(torch.zeros(shape), 1)
    assert not launches


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(10, 4).T,                       # a column a row
    lambda: torch.zeros(4, 20)[:, ::2],                 # every other entry
    lambda: torch.zeros(1, 10).expand(3, 10),           # rows on top of each other
])
def test_refuses_rows_without_unit_stride(launches, make):
    with pytest.raises(ValueError):
        topk.top_k_kernel(make(), 2)
    assert not launches


@pytest.mark.parametrize("I,k", [(10, 0), (10, -1), (10, 11), (1, 2), (0, 1)])
def test_refuses_k_outside_one_to_the_row(launches, I, k):
    with pytest.raises(ValueError):
        topk.top_k_kernel(torch.zeros(3, I), k)
    assert not launches


@pytest.mark.parametrize("path", topk.PATHS)
@pytest.mark.parametrize("I", [1, 57, 38546, 91599])
def test_the_launches_count_the_path_the_kernel_took(launches, I, path):
    launches.path = path
    k = min(3, I)
    vals, ids = topk.top_k_kernel(torch.randn(2, I), k)
    assert [c[2] for c in launches] == [False]  # the kernel chooses the path
    assert _build.LAUNCHES["topk"] == 1 and _build.LAUNCHES["topk_" + path] == 1
    assert sum(_build.LAUNCHES["topk_" + p] for p in topk.PATHS) == 1
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64 and ids.shape == (2, k)


def test_rows_that_lie_apart_reach_the_kernel_as_they_are(launches):
    wide = torch.randn(6, 41)
    x = wide[:, :40]
    vals, ids = topk.top_k_kernel(x, 5)
    (got, k, _), = launches
    assert got.data_ptr() == x.data_ptr() and got.stride() == (41, 1) and k == 5
    want = topk.top_k_reference(x, 5)
    assert torch.equal(ids, want[1]) and torch.equal(vals, want[0])


def test_an_empty_batch_launches_nothing(launches):
    vals, ids = topk.top_k_kernel(torch.zeros(0, 30), 4)
    assert vals.shape == ids.shape == (0, 4) and not launches
    assert _build.LAUNCHES["topk"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_a_cpu_tensor_takes_the_plain_version(monkeypatch, seed):
    def refuse(*args):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(topk, "_run", refuse)
    x = torch.from_numpy(np.random.RandomState(seed).randint(-2, 3, (5, 33)).astype(np.float32))
    got, want = topk.top_k(x, 7), topk.top_k_reference(x, 7)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    # leading axes and other float dtypes stay the plain version's
    assert topk.top_k(x[None].bfloat16(), 3)[0].dtype == torch.bfloat16


def test_the_launch_refuses_a_cpu_tensor():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="runs on cuda"):
        topk._run(x, 2, torch.empty(2, 2), torch.empty(2, 2, dtype=torch.int64))
