"""An epoch's steps as CUDA-graph replays: the port's counterpart of the
JAX trainer's ``jax.jit(epoch, donate_argnums=(0, 1))`` over
``lax.scan(step, unroll=scan_unroll)`` (``neurec_tpu/trainer.py:355-475``).

``run_steps(step, n, seeds, device, unroll, capture)`` takes ``n`` steps.
``step(generator)`` is one training step: it reads its step's index from
device state and advances it itself, draws what it draws from
``generator`` (None where ``seeds`` is None), synchronises nothing with
the host, and holds no Python value that changes from step to step. Before
step ``s`` runs, its generator is seeded with ``seeds[s]`` on the host.

Without ``capture`` (the CPU, ``Trainer(graphs=False)``, a mesh of more
than one rank) the steps run eagerly, one call each, on one generator.

With ``capture`` (a CUDA device):

* step 0 runs eagerly on a side stream. It is the epoch's real first step
  and the warm-up that capture needs: the optimizer's state, the SpMM
  schedules and layouts, cuBLAS's workspace and the kernel libraries come
  into being here, outside any graph;
* ``k = min(unroll, n - 1)`` consecutive steps are captured into one
  ``torch.cuda.CUDAGraph`` and the remaining ``(n - 1) % k`` into a second,
  on one memory pool. Position ``j`` of a graph draws from a generator of
  its own, registered with the graph (``register_generator_state``), so a
  replay draws from the seeds set on the host before it, as the eager step
  does;
* the first graph is replayed ``(n - 1) // k`` times, then the second once.

The graphs are captured anew on every call, as ``jax.jit`` traces anew for
new static arguments: what a step reads at capture (the epoch's tensors,
the epoch number, ``NEUREC_SPMM_PACK``, a wrapper replaced by its plain
version) is that call's. They are released with their pool when the call
ends. A failed capture raises; nothing falls back to eager steps.

Kernel launch counts (``ops/_build.py::LAUNCHES``): a replay calls no
wrapper, so each graph's launches are taken while it is captured and added
once a replay.

``take_steps(Steps(make, n, seeds, opt, split), device, unroll, capture)``
is a run of steps as an epoch holds it: a fresh device cursor and loss
total, ``make(cursor, total)`` the step function over them, ``run_steps``
inside ``opt``'s device count (``OptaxAdam.count_steps``), the gradients
released at the end (a captured run's live in the graphs' pool). The
built-in epochs (``Trainer.run_epoch``) and the custom ones (each model's
``build_epoch``: SBPR, SASRec, Caser, SRGNN, GRU4Rec, GRU4RecPlus, JCA,
CFGAN's sub-epochs, IRGAN's passes) take their steps through it, by
``Trainer.take_steps``. A step reads the epoch's tensors at the cursor
(``at``), draws from the generator it is handed, seeded from
``step_seeds``, which the epoch's generator draws on the host before the
steps, and ends in ``train_step``.

``KeptProgram(prologue, body, device, capture)`` is the other form: a
program kept across calls, the evaluator's and the serving export's (the
JAX package's jitted evaluation and export, cached per predict function
and per model). Its first call runs eagerly and captures a graph of the
prologue and one of the body; later calls replay the prologue once and
the body once a batch. The caller keeps it while what it captured holds:
``signature`` of the tensors it reads (an update in place keeps it) and
``routes``, the SpMM variables and the kernels' wrappers at capture.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.parallel.mesh import batch_split

Step = Callable[[Optional[torch.Generator]], None]


class _CudaGraphs:
    """The CUDA side of a captured run, a context on ``device``: a side
    stream, one memory pool and the graphs captured on them, released at
    exit, or with ``keep`` by ``release`` (a ``KeptProgram``'s, entered
    again for each call's replays)."""

    def __init__(self, device: torch.device, keep: bool = False):
        self.device = device
        self.keep = keep
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.stream = self.pool = None

    def __enter__(self) -> "_CudaGraphs":
        self._device_ctx = torch.cuda.device(self.device)
        self._device_ctx.__enter__()
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        return self

    def __exit__(self, *exc) -> None:
        if not self.keep:
            self.release()
        self._device_ctx.__exit__(*exc)

    def release(self) -> None:
        for graph in self.graphs:
            graph.reset()
        self.graphs.clear()

    def warm_up(self, fn: Callable[[], None]) -> None:
        """``fn`` run eagerly on the side stream, ordered after and before
        the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], None], generators: List[torch.Generator]) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        self.graphs.append(graph)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            fn()
        return graph

    @staticmethod
    def replay(graph: torch.cuda.CUDAGraph) -> None:
        graph.replay()

    def reserved(self, empty: bool = False) -> int:
        """The caching allocator's reserved bytes on the device; with
        ``empty`` after freeing its unused cached blocks
        (``torch.cuda.empty_cache``, as a capture does when it begins)."""
        if empty:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)


def _seed(generators: List[torch.Generator], seeds, s: int, count: int) -> None:
    """Generator ``j`` seeded with ``seeds[s + j]`` for ``j < count``."""
    if seeds is None:
        return
    for j in range(count):
        generators[j].manual_seed(int(seeds[s + j]))


def run_steps(step: Step, n: int, seeds: Optional[torch.Tensor], device: torch.device, unroll: int = 1,
              capture: bool = False) -> None:
    """Take ``n`` steps of ``step``: eagerly, or with ``capture`` as
    replays of CUDA graphs of ``unroll`` steps (see the module's
    docstring). ``seeds`` (n,) on the host, or None for steps that draw
    nothing."""
    if n <= 0:
        return
    width = max(1, min(unroll, n - 1)) if capture else 1
    gens = [] if seeds is None else [torch.Generator(device=device) for _ in range(width)]

    def steps_at(count: int) -> Callable[[], None]:
        def run():
            for j in range(count):
                step(gens[j] if gens else None)
        return run

    if not capture:
        for s in range(n):
            _seed(gens, seeds, s, 1)
            steps_at(1)()
        return
    with _CudaGraphs(device) as cuda:
        _seed(gens, seeds, 0, 1)
        cuda.warm_up(steps_at(1))
        rest = n - 1
        if rest == 0:
            return
        k = min(unroll, rest)
        runs = [(k, rest // k)] + ([(rest % k, 1)] if rest % k else [])
        graphs = []
        for count, times in runs:
            with _build.captured_launches() as launches:
                graph = cuda.capture(steps_at(count), gens[:count])
            graphs.append((graph, count, times, launches))
        s = 1
        for graph, count, times, launches in graphs:
            for _ in range(times):
                _seed(gens, seeds, s, count)
                cuda.replay(graph)
                _build.add_launches(launches)
                s += count


class Steps(NamedTuple):
    """A run of ``n`` steps: ``make(cursor, total)`` builds the step function
    over a (1,) int64 device cursor and a 0-d f32 device loss total; the
    steps' ``seeds`` (n,) on the host, or None where a step draws nothing;
    ``opt`` the optimizer they step, or None (IRGAN's SGD by hand); ``split``
    the step's 'data' split on a mesh (``Trainer.dp_split_for``), or None."""

    make: Callable[[torch.Tensor, torch.Tensor], Step]
    n: int
    seeds: Optional[torch.Tensor] = None
    opt: Any = None
    split: Any = None


def at(cursor: torch.Tensor, *tensors: torch.Tensor):
    """Row ``cursor`` of each tensor, read on the device (``index_select``,
    no host sync): one tensor for one, a tuple for several."""
    rows = tuple(t.index_select(0, cursor)[0] for t in tensors)
    return rows[0] if len(rows) == 1 else rows


def train_step(loss_fn: Callable[[], torch.Tensor], opt, cursor: torch.Tensor, total: torch.Tensor, trainer=None,
               split=None, synced=None) -> torch.Tensor:
    """The tail of a training step: ``loss_fn()`` and its backward inside
    the step's 'data' split, the gradients of the tree ``synced`` summed
    over 'data' (``Trainer.dp_sync_grads``; a whole step has nothing to
    sum), ``opt``'s step; the loss is added to ``total`` and ``cursor``
    advanced, on the device. Returns the loss."""
    opt.zero_grad(set_to_none=True)
    with batch_split(split):
        loss = loss_fn()
        loss.backward()
    if trainer is not None:
        trainer.dp_sync_grads(synced, split)
    opt.step()
    total.add_(loss.detach())
    cursor.add_(1)
    return loss


def step_seeds(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) int64 seeds on the host, one a step, drawn from ``generator``."""
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).cpu()


def take_steps(steps: Steps, device: torch.device, unroll: int = 1, capture: bool = False) -> torch.Tensor:
    """Run ``steps`` (see the module's docstring): the summed step losses,
    a 0-d f32 tensor on ``device``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)
    count = getattr(steps.opt, "count_steps", None)
    with count(steps.n) if count is not None else contextlib.nullcontext():
        run_steps(steps.make(cursor, total), steps.n, steps.seeds, device, unroll, capture)
    if steps.opt is not None:
        steps.opt.zero_grad(set_to_none=True)
    return total


# the variables a SpMM call reads when it runs (``ops/graph.py``,
# ``ops/spmm.py``): a kept program holds the branch they chose at capture
SPMM_ENV = ("NEUREC_SPMM_PACK", "NEUREC_SPMM_DTYPE", "NEUREC_SPMM_PALLAS")


def routes() -> tuple:
    """What a capture holds besides the tensors it reads: the values of
    ``SPMM_ENV`` now (None where unset) and the module-level kernel
    wrappers the ops look up at each call (K1's, K2's, K3's), so that a
    kept program is captured anew after a change of either (a wrapper
    replaced by its plain version, say)."""
    from neurec_tpu_torch.ops import masked_scores as k1, spmm as k2

    wrappers = (k1.masked_scores, k1.masked_scores_bits, k2.plan_spmm, k2.plan_scatter, k2.plan_spmm_packed)
    return tuple(os.environ.get(name) for name in SPMM_ENV) + wrappers


def signature(tree) -> tuple:
    """What a captured graph holds of a tree of tensors (dicts, lists and
    tuples of them): each tensor's (data pointer, shape, dtype, strides),
    other leaves as they are. Equal signatures mean a graph captured over
    one tree reads the other's values; an update in place keeps it. Other
    objects stand for themselves by identity."""
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(), tuple(tree.shape), tree.dtype, tree.stride())
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return (tree,) if isinstance(tree, (int, float, str, bool, type(None))) else (id(tree),)


class KeptProgram:
    """A program of ``prologue`` once and ``body`` n times, kept across
    calls: the counterpart of a jitted ``lax.scan`` that the JAX package
    keeps in its cache (the evaluator's ``full_catalog_all`` /
    ``candidate_all``, the serving export).

    Both run over device state they own (a cursor that ``prologue`` zeroes
    and ``body`` reads at and advances, totals, static input and output
    buffers) and read no host value that changes from call to call.

    With ``capture`` the first ``run`` is the warm-up that capture needs:
    the call runs eagerly on a side stream (the kernel libraries load, what
    they cache is built, and the call's results are real), then the
    prologue and the body are each captured into a graph on one memory
    pool, which runs nothing. Every later ``run`` replays the prologue's
    graph once and the body's ``n`` times: ``n + 1`` graph launches, no host
    sync. So every call counts each kernel's launches once, as an eager
    call does: the first by its wrappers, the later ones by the launches a
    capture took, added once a replay (as in ``run_steps``). ``pool_bytes``
    is the allocator's reserved memory grown over the captures. A failed
    capture raises and leaves no graph; ``release`` resets the graphs.
    """

    def __init__(self, prologue: Callable[[], None], body: Callable[[], None], device: torch.device,
                 capture: bool):
        self.prologue, self.body = prologue, body
        self.device, self.capture = device, capture
        self.pool_bytes = 0
        self._graphs = None

    def _eager(self, n: int) -> None:
        self.prologue()
        for _ in range(n):
            self.body()

    def run(self, n: int) -> None:
        if not self.capture:
            self._eager(n)
        elif self._graphs is None:
            self._capture(n)
        else:
            cuda, (prologue, p_launches), (body, b_launches) = self._graphs
            with cuda:
                cuda.replay(prologue)
                _build.add_launches(p_launches)
                for _ in range(n):
                    cuda.replay(body)
                    _build.add_launches(b_launches)

    def _capture(self, n: int) -> None:
        cuda = _CudaGraphs(self.device, keep=True)
        try:
            with cuda:
                cuda.warm_up(lambda: self._eager(n))
                before = cuda.reserved(empty=True)
                with _build.captured_launches() as p_launches:
                    prologue = cuda.capture(self.prologue, [])
                with _build.captured_launches() as b_launches:
                    body = cuda.capture(self.body, [])
                self.pool_bytes = cuda.reserved() - before
        except BaseException:
            cuda.release()
            raise
        self._graphs = cuda, (prologue, p_launches), (body, b_launches)

    def release(self) -> None:
        if self._graphs is not None:
            self._graphs[0].release()
            self._graphs = None
        self.prologue = self.body = None
