"""The program runtime's two shared mechanisms, on the CPU.

* ``step_graph.KeptStore``, where the trainer, the evaluator and the
  serving export keep their programs: the same holding gives the same
  program; a changed holding, a program that no longer fits, a swapped
  kernel wrapper or a changed SpMM variable (``routes``) release it and
  make a new one; past its limit the least recently used is released; a
  make or a use that raises keeps nothing. ``step_graph.captures`` is the
  one rule for where programs run as CUDA graphs. No garbage collection
  runs inside a capture (a dead program's graph reset there invalidates
  it).
* ``ops/_build.Entry``, the one binding of a kernel library's entry point,
  with the library stood in: it binds once, passes the current stream
  last, switches device only where needed, raises on an error code and
  counts the launches it is given; each ops module declares its
  swappable wrappers (``_build.swappable``), and ``step_graph`` imports no
  ops module but ``_build``.
"""

import ast
import contextlib
import ctypes
import gc
import os
import types

import pytest
import torch

from neurec_tpu_torch import step_graph
from neurec_tpu_torch.ops import _build, hstu, spmm, topk
from neurec_tpu_torch.ops import masked_scores as k1

PACKAGE = os.path.dirname(os.path.abspath(step_graph.__file__))


class Program:
    """A stand-in program: records its release."""

    made = []

    def __init__(self, rows=None):
        self.rows, self.released = rows, False
        Program.made.append(self)

    def release(self):
        self.released = True


@pytest.fixture
def made():
    Program.made = []
    return Program.made


def use(store, key, holding, fits=None, rows=None):
    with store.use(key, lambda: holding, lambda: Program(rows), fits) as program:
        return program


def test_the_same_holding_gives_the_same_program(made):
    store = step_graph.KeptStore()
    first = use(store, "a", (1, "x"))
    assert use(store, "a", (1, "x")) is first and len(made) == 1
    assert dict(store) == {"a": first} and store.get("b") is None


def test_a_changed_holding_releases_and_makes_anew(made):
    store = step_graph.KeptStore()
    first = use(store, "a", 1)
    second = use(store, "a", 2)
    assert second is not first and first.released and not second.released
    assert store["a"] is second and len(store) == 1


def test_a_program_that_no_longer_fits_is_made_anew(made):
    store = step_graph.KeptStore()
    first = use(store, "a", 1, lambda p: True, rows=4)
    assert use(store, "a", 1, lambda p: 3 <= p.rows) is first
    second = use(store, "a", 1, lambda p: 5 <= p.rows, rows=5)
    assert second is not first and first.released


def test_the_holding_is_taken_after_the_first_use(made):
    """The first use may make state that the program reads (Adam's, at a
    run's first step): the program holds what stood after it."""
    store = step_graph.KeptStore()
    state = []
    with store.use("a", lambda: len(state), Program) as first:
        state.append(1)
    with store.use("a", lambda: len(state), Program) as again:
        pass
    assert again is first and len(made) == 1


def test_past_its_limit_the_least_recently_used_is_released(made):
    store = step_graph.KeptStore(most=2)
    a, b = use(store, "a", 0), use(store, "b", 0)
    assert use(store, "a", 0) is a  # a is now the most recent
    c = use(store, "c", 0)
    assert list(store) == ["a", "c"] and b.released and not (a.released or c.released)


def test_a_raise_keeps_nothing(made):
    store = step_graph.KeptStore()

    def failing():
        raise RuntimeError("make failed")

    with pytest.raises(RuntimeError, match="make failed"):
        with store.use("a", lambda: 0, failing):
            pass
    assert not store
    kept = use(store, "a", 0)
    with pytest.raises(RuntimeError, match="run failed"):
        with store.use("a", lambda: 0, Program) as program:
            assert program is kept
            raise RuntimeError("run failed")
    assert not store and kept.released


def test_release_one_or_all(made):
    store = step_graph.KeptStore()
    a, b = use(store, "a", 0), use(store, "b", 0)
    store.release("a")
    assert list(store) == ["b"] and a.released and not b.released
    store.release("missing")
    store.release()
    assert not store and b.released


def test_a_swapped_wrapper_or_spmm_variable_makes_anew(made, monkeypatch):
    store = step_graph.KeptStore()
    monkeypatch.delenv("NEUREC_SPMM_PACK", raising=False)
    first = use(store, "a", 0)
    monkeypatch.setattr(topk, "top_k_kernel", topk.top_k_reference)
    assert ("neurec_tpu_torch.ops.topk", "top_k_kernel", topk.top_k_reference) in step_graph.routes()
    second = use(store, "a", 0)
    assert second is not first and first.released
    monkeypatch.undo()
    assert _build.swapped() == ()
    third = use(store, "a", 0)
    assert third is not second and second.released
    monkeypatch.setenv("NEUREC_SPMM_PACK", "2")
    assert use(store, "a", 0) is not third and third.released


def test_each_ops_module_declares_its_wrappers():
    declared = {key for key in _build.WRAPPERS}
    assert declared == {
        (k1.__name__, "masked_scores"), (k1.__name__, "masked_scores_bits"),
        (spmm.__name__, "plan_spmm"), (spmm.__name__, "plan_scatter"), (spmm.__name__, "plan_spmm_packed"),
        (hstu.__name__, "attention_kernel"), (hstu.__name__, "layer_in"), (hstu.__name__, "layer_out"),
        (topk.__name__, "top_k_kernel"),
    }
    assert all(_build.WRAPPERS[key] is getattr(mod, key[1]) for mod in (k1, spmm, hstu, topk)
               for key in _build.WRAPPERS if key[0] == mod.__name__)


def test_step_graph_imports_no_ops_module_but_the_loader():
    tree = ast.parse(open(os.path.join(PACKAGE, "step_graph.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("neurec_tpu_torch.ops"):
            names |= {node.module + "." + a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {a.name for a in node.names if a.name.startswith("neurec_tpu_torch.ops")}
    assert names == {"neurec_tpu_torch.ops._build"}


def test_argtypes_are_set_only_by_the_loader_and_the_host_library():
    setters = []
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".py") and "argtypes" in open(path).read():
                setters.append(os.path.relpath(path, PACKAGE))
    assert sorted(setters) == [os.path.join("native", "__init__.py"), os.path.join("ops", "_build.py")]


@pytest.mark.parametrize("device,graphs,ranks,want", [
    ("cuda", True, None, True),
    ("cuda", False, None, False),
    ("cpu", True, None, False),
    ("cuda", True, 1, True),
    ("cuda", True, 2, False),
])
def test_captures_on_a_card_with_graphs_and_one_rank(device, graphs, ranks, want):
    mesh = None if ranks is None else types.SimpleNamespace(size=ranks)  # what the rule reads of a Mesh
    assert step_graph.captures(torch.device(device), graphs, mesh) is want


@pytest.mark.parametrize("collecting", [True, False])
def test_a_capture_holds_the_garbage_collector_off(collecting, monkeypatch):
    class Graph:  # the CUDA side stood in
        def register_generator_state(self, gen):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None, stream=None: contextlib.nullcontext())
    cuda = step_graph._CudaGraphs(torch.device("cpu"))
    inside = []

    def failing():
        inside.append(gc.isenabled())
        raise RuntimeError("capture failed")

    was = gc.isenabled()
    (gc.enable if collecting else gc.disable)()
    try:
        cuda.capture(lambda: inside.append(gc.isenabled()), [])
        with pytest.raises(RuntimeError, match="capture failed"):
            cuda.capture(failing, [])
        after = gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert inside == [False, False] and after is collecting and len(cuda.graphs) == 2


# -- the entry-point binding, the library stood in ---------------------------

class FakeFn:
    def __init__(self, code=0, result=None):
        self.code, self.result, self.calls = code, result, []
        self.restype = self.argtypes = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.result if self.result is not None else self.code


@pytest.fixture
def fake(monkeypatch):
    """``_build.load`` returning a stand-in library (its loads counted), the
    CUDA runtime's current device 0 and stream 77, device switches
    recorded; the launch counts a copy."""
    lib = types.SimpleNamespace(neurec_fake=FakeFn(), neurec_error_string=FakeFn(result=b"fake error"),
                                loads=[], switches=[])

    def load(name, device=None):
        lib.loads.append((name, device))
        return lib

    @contextlib.contextmanager
    def switch(device):
        lib.switches.append(device)
        yield

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "device", switch)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    return lib


def test_an_entry_binds_once_and_counts_what_it_is_given(fake):
    entry = _build.Entry("fake", "neurec_fake", [ctypes.c_void_p, ctypes.c_int])
    assert not fake.loads  # nothing is loaded before the first launch
    cuda0 = torch.device("cuda", 0)
    entry(cuda0, 1234, 5, counts=("topk", "topk_resident"))
    entry(cuda0, 1235, 6, counts=("topk",))
    fn = fake.neurec_fake
    assert fake.loads == [("fake", cuda0)]
    assert fn.restype is ctypes.c_int and fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert fn.calls == [(1234, 5, 77), (1235, 6, 77)]  # the stream last
    assert _build.LAUNCHES["topk"] == 2 and _build.LAUNCHES["topk_resident"] == 1
    assert sum(_build.LAUNCHES.values()) == 3
    assert not fake.switches  # device 0 is current
    entry(torch.device("cuda", 1), 1, 2)
    assert fake.switches == [torch.device("cuda", 1)] and sum(_build.LAUNCHES.values()) == 3


def test_an_entry_raises_on_an_error_and_counts_nothing(fake):
    entry = _build.Entry("fake", "neurec_fake", [ctypes.c_int])
    fake.neurec_fake.code = 3
    with pytest.raises(RuntimeError, match=r"neurec_fake kernel launch failed: cuda error 3 \(fake error\)"):
        entry(torch.device("cuda", 0), 1, counts=("topk",))
    assert _build.LAUNCHES["topk"] == 0
