"""An epoch's steps as CUDA-graph replays, kept across epochs: the port's
counterpart of the JAX trainer's ``jax.jit(epoch, donate_argnums=(0, 1))``
over ``lax.scan(step, unroll=scan_unroll)`` (``neurec_tpu/trainer.py:355-475``).
The JAX trainer builds that epoch once, in ``initialize``, and calls it every
epoch with the key and the epoch index as traced arguments: it traces and
compiles at epoch 1, and epochs 2..N run the same executable. The port
likewise captures a run of steps once a ``Trainer`` (``KeptSteps``) and
replays it every later call.

``step(generator)`` is one training step: it reads its step's index from
device state and advances it itself, draws what it draws from
``generator`` (None where the run has no seeds), synchronises nothing with
the host, and holds no Python value that changes from step to step or from
call to call. Before step ``s`` runs, its generator is seeded with
``seeds[s]`` on the host.

``run_steps(step, n, seeds, device)`` takes ``n`` steps eagerly, one call
each, on one generator: the CPU, ``Trainer(graphs=False)``, a mesh of more
than one rank.

On a CUDA device a ``KeptSteps`` takes them through ``_StepGraphs``:

* at the first call step 0 runs eagerly on a side stream. It is the
  epoch's real first step and the warm-up that capture needs: the
  optimizer's state, the SpMM schedules and layouts, cuBLAS's workspace and
  the kernel libraries come into being here, outside any graph;
* ``k = min(unroll, n - 1)`` consecutive steps are captured into one
  ``torch.cuda.CUDAGraph``, on one memory pool. Position ``j`` of a graph
  draws from a generator of its own, registered with the graph
  (``register_generator_state``), so a replay draws from the seeds set on
  the host before it, as the eager step does;
* the ``k``-step graph is replayed ``m // k`` times over the ``m`` steps
  left (``n - 1`` at the first call, ``n`` later), then a graph of the
  ``m % k`` steps left, kept by count. The first call captures the graphs
  of ``(n - 1) % k`` steps, its own remainder, and of ``n % k``, a later
  call's, so that a later call of the same ``n`` captures nothing; a
  count not seen before (``n`` changes with ``max_steps`` and GRU4Rec's
  live prefix) is captured when it is first needed. A step leaves nothing
  in the pool that a later graph reads (it starts by releasing the
  gradients, and every state it carries lives in buffers made outside the
  pool), so the graphs may replay in another order than their captures'.

A failed capture raises; nothing falls back to eager steps.

Kernel launch counts (``ops/_build.py::LAUNCHES``): a replay calls no
wrapper, so each graph's launches are taken while it is captured and added
once a replay.

``Steps(make, n, seeds, opt, split, inputs, reads, updates, name, most)``
is a run of steps as an epoch holds it: ``make(cursor, total, **inputs)``
the step function over a device cursor, a loss total and the run's
tensors, run inside ``opt``'s device count (``OptaxAdam.count_steps``),
the gradients released at the end (a captured run's live in the graphs'
pool). The built-in epochs (``Trainer.run_epoch``) and the custom ones
(each model's ``build_epoch``: SBPR, SASRec, Caser, SRGNN, GRU4Rec,
GRU4RecPlus, JCA, CFGAN's sub-epochs, IRGAN's passes) take their steps
through ``Trainer.take_steps``: eagerly by ``take_steps``, or where the
trainer captures as a ``KeptSteps`` it keeps under the run's ``name`` for
its whole life. A step reads the run's tensors at the cursor (``at``),
draws from the generator it is handed, seeded from ``step_seeds``, which
the epoch's generator draws on the host before the steps, and ends in
``train_step``.

``KeptProgram(prologue, body, device, capture)`` is the evaluator's and the
serving export's form (the JAX package's jitted evaluation and export,
cached per predict function and per model). Its first call runs eagerly
and captures a graph of the prologue and one of the body; later calls
replay the prologue once and the body once a batch. The caller keeps it
while what it captured holds: ``signature`` of the tensors it reads (an
update in place keeps it) and ``routes``, the SpMM variables and the
kernels' wrappers at capture. A ``KeptSteps`` holds by the same rule.
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
    stream, one memory pool and the graphs captured on them, kept until
    ``release`` (a kept run's and a ``KeptProgram``'s are entered again for
    each call's replays)."""

    def __init__(self, device: torch.device):
        self.device = device
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


class _StepGraphs:
    """The CUDA graphs of one step function, kept across runs: the first
    run takes step 0 eagerly (the warm-up) and captures ``k = min(unroll,
    n - 1)`` steps into one graph; every run replays that graph, then a
    graph of the ``k``-steps' remainder, the first run capturing its own
    and a later run's of ``n`` steps, any other captured the first time its
    count is needed (see the module's docstring). ``captured`` is
    the graphs the last run captured, ``pool_bytes`` the allocator's
    reserved memory grown over every capture."""

    def __init__(self, step: Step, device: torch.device, unroll: int, draws: bool):
        self.step, self.device, self.unroll, self.draws = step, device, unroll, draws
        self.cuda = _CudaGraphs(device)
        self.gens: List[torch.Generator] = []
        self.width: Optional[int] = None
        self.graphs = {}  # steps a graph -> (graph, the launches its capture took)
        self.captured = self.pool_bytes = 0

    def _steps_at(self, count: int) -> Callable[[], None]:
        def run():
            for j in range(count):
                self.step(self.gens[j] if self.gens else None)
        return run

    def run(self, n: int, seeds: Optional[torch.Tensor]) -> None:
        """Steps ``0 .. n-1`` of this run, step ``s`` drawing from
        ``seeds[s]``."""
        self.captured = 0
        if n <= 0:
            return
        with self.cuda as cuda:
            s = 0
            if self.width is None:
                self.width = max(1, min(self.unroll, n - 1))
                if self.draws:
                    self.gens = [torch.Generator(device=self.device) for _ in range(self.width)]
                _seed(self.gens, seeds, 0, 1)
                cuda.warm_up(self._steps_at(1))
                s = 1
            k = self.width
            runs = [(count, times) for count, times in ((k, (n - s) // k), ((n - s) % k, 1)) if count and times]
            # the first call captures besides the remainder of a later call
            # of n steps, so that such a call captures nothing
            needed = [count for count, _ in runs] + [n % k] * s
            missing = [count for count in dict.fromkeys(needed) if count and count not in self.graphs]
            if missing:
                before = cuda.reserved(empty=True)
                for count in missing:
                    with _build.captured_launches() as launches:
                        self.graphs[count] = cuda.capture(self._steps_at(count), self.gens[:count]), launches
                self.captured = len(missing)
                self.pool_bytes += cuda.reserved() - before
            for count, times in runs:
                graph, launches = self.graphs[count]
                for _ in range(times):
                    _seed(self.gens, seeds, s, count)
                    cuda.replay(graph)
                    _build.add_launches(launches)
                    s += count

    def release(self) -> None:
        self.cuda.release()
        self.graphs.clear()
        self.step = None


def run_steps(step: Step, n: int, seeds: Optional[torch.Tensor], device: torch.device) -> None:
    """Take ``n`` steps of ``step`` eagerly, step ``s``'s generator seeded
    with ``seeds[s]`` ((n,) on the host, or None for steps that draw
    nothing)."""
    gens = [] if seeds is None else [torch.Generator(device=device)]
    for s in range(n):
        _seed(gens, seeds, s, 1)
        step(gens[0] if gens else None)


class Steps(NamedTuple):
    """A run of ``n`` steps.

    ``make(cursor, total, **inputs)`` builds the step function over a (1,)
    int64 device cursor, a 0-d f32 device loss total and the run's
    ``inputs``; ``seeds`` (n,) on the host,
    or None where a step draws nothing; ``opt`` the optimizer they step,
    or None (IRGAN's SGD by hand); ``split`` the step's 'data' split on a
    mesh (``Trainer.dp_split_for``), or None.

    ``inputs`` are the tensors (and dicts and lists of them) that the call
    made and the steps read, by ``make``'s parameter names; a kept run
    (``KeptSteps``) copies them into buffers of its own. What it needs
    besides: ``reads``, the tree of tensors the steps read that outlive the
    call (the params); ``updates``, the names of the inputs that the steps
    update in place and the caller reads after the run (IRGAN's players),
    copied back; ``name``, the run
    a trainer keeps the program under (an epoch's, or one pass of a
    custom epoch's); ``most``, the most steps a call of this run takes
    where calls differ (GRU4Rec's live prefix), else ``n``."""

    make: Callable[..., Step]
    n: int
    seeds: Optional[torch.Tensor] = None
    opt: Any = None
    split: Any = None
    inputs: dict = {}
    reads: Any = None
    updates: tuple = ()
    name: str = "epoch"
    most: Optional[int] = None


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


def take_steps(steps: Steps, device: torch.device) -> torch.Tensor:
    """Run ``steps`` once, eagerly, over the call's tensors, a fresh device
    cursor and loss total. Returns the summed step losses, a 0-d f32 tensor
    on ``device``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)
    count = getattr(steps.opt, "count_steps", None)
    with count(steps.n) if count is not None else contextlib.nullcontext():
        run_steps(steps.make(cursor, total, **steps.inputs), steps.n, steps.seeds, device)
    if steps.opt is not None:
        steps.opt.zero_grad(set_to_none=True)
    return total


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _copy_tree(dst, src) -> None:
    """Each tensor of ``src`` copied into the same place of ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    else:
        dst.copy_(src)


def _layout(tree) -> tuple:
    """The shapes and dtypes of a tree of tensors."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.requires_grad
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    return tuple(_layout(v) for v in tree)


def _opt_signature(opt) -> tuple:
    """What a graph holds of an optimizer: the object, its params and its
    state's tensors."""
    if opt is None:
        return ()
    state = [[v for v in st.values() if isinstance(v, torch.Tensor)] for st in opt.state.values()]
    return (id(opt), signature([g["params"] for g in opt.param_groups]), signature(state))


class KeptSteps:
    """A run of steps kept across calls: the counterpart of the JAX
    trainer's epoch, jitted once in ``initialize`` and called every epoch
    with the key and the epoch as traced arguments
    (``neurec_tpu/trainer.py:423,475,490,517-522``).

    It owns static buffers for what a step reads that changes per call: a
    copy of each of the run's ``inputs`` (the epoch's draws, the epoch
    number as a 0-d device tensor, a pass's player), the cursor and the
    loss total, the optimizer's device count tables
    (``OptaxAdam.count_steps``), and the generator of each graph position.
    Its step function is built once, over those buffers.

    Each ``run(steps)`` copies the call's inputs into the buffers, zeroes
    the cursor and the total and takes ``steps.n`` steps through
    ``_StepGraphs``: the first call runs step 0 eagerly and captures, the
    later ones replay (the remainder graph of a new count captured when it
    is first needed); the optimizer's tables are refilled in place for the
    call's steps. ``updates`` are copied back to the call's tensors.

    The program holds while ``holds(steps, unroll)``: the same
    ``scan_unroll``, the tensors of ``reads`` and the optimizer's params
    and state where they were (an update in place keeps them), the inputs'
    shapes and dtypes, ``routes()`` (the SpMM variables, the kernels'
    wrappers) as at capture, and ``n`` within its count tables. A failed
    capture or replay raises; nothing falls back to eager steps."""

    def __init__(self, steps: Steps, device: torch.device, unroll: int):
        self.device, self.unroll = device, unroll
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.total = torch.zeros((), dtype=torch.float32, device=device)
        self.inputs = _tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), steps.inputs)
        step = steps.make(self.cursor, self.total, **self.inputs)
        self.graphs = _StepGraphs(step, device, unroll, steps.seeds is not None)
        self.count = None  # the optimizer's device count (``_DeviceCount``)
        self.calls = 0
        self._held = None

    @property
    def captured(self) -> int:
        """The graphs the last call captured."""
        return self.graphs.captured

    @property
    def pool_bytes(self) -> int:
        return self.graphs.pool_bytes

    def _holding(self, steps: Steps) -> tuple:
        return (routes(), signature(steps.reads), _opt_signature(steps.opt), _layout(steps.inputs),
                steps.seeds is None)

    def holds(self, steps: Steps, unroll: int) -> bool:
        """Whether a call of ``steps`` at ``unroll`` may replay this
        program (see the class docstring)."""
        rows = self.count.rows if self.count is not None else steps.n
        return self.unroll == unroll and steps.n <= rows and self._held == self._holding(steps)

    def run(self, steps: Steps) -> torch.Tensor:
        """The call's steps; returns their summed losses (a fresh 0-d f32
        tensor on the device)."""
        if steps.n <= 0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        if self.calls:
            with torch.no_grad():
                _copy_tree(self.inputs, steps.inputs)
            self.cursor.zero_()
            self.total.zero_()
        count = getattr(steps.opt, "count_steps", None)
        with count(steps.n, self.count, steps.most) if count is not None else contextlib.nullcontext() as held:
            self.count = held
            self.graphs.run(steps.n, steps.seeds)
        with torch.no_grad():
            for name in steps.updates:
                _copy_tree(steps.inputs[name], self.inputs[name])
        if steps.opt is not None:
            steps.opt.zero_grad(set_to_none=True)
        if not self.calls:
            self._held = self._holding(steps)
        self.calls += 1
        return self.total.clone()

    def release(self) -> None:
        self.graphs.release()
        self.inputs = self.count = None


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
    capture took, added once a replay (as a ``KeptSteps``'s). ``pool_bytes``
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
        cuda = _CudaGraphs(self.device)
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
