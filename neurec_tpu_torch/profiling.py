"""Tracing / profiling utilities (port of ``neurec_tpu/profiling.py``).

The reference's only tracing is a wall-clock ``@timer`` decorator
(util/tool.py:203-213). That is kept for log parity, plus a
``torch.profiler`` trace context for device profiles (Chrome / Perfetto
JSON, which TensorBoard's profiler plugin also reads), and the program's
spans.

Spans. ``span(name, **attrs)`` marks a stretch of the program's host work
at a layer boundary: the trainer's draw and run of an epoch, the kept
steps' input copies, count tables, captures and replays, an evaluation
call, a serving request and their parts. Every name starts with
``neurec.``. A span records only while tracing is on: while a
``torch.profiler`` session runs in the process (``device_trace``, or one a
caller opened itself), or inside a ``tracing()`` block, which fills the
store with no profiler. Off, a span is one check: it opens nothing, reads
no clock and builds nothing. On, it opens a ``record_function`` range
when a profiler runs, so that the span lands on the device trace's clock
beside the kernels as a ``user_annotation``, and it appends a ``Span`` to
the in-memory store: its name, host start and end (``perf_counter_ns``),
its parent span's index, the index of the top span of its call, and its
attributes. A span never synchronises with the device and never reads a
device value; what its attributes count (bytes copied, graphs captured)
comes from shapes and host state. ``count(**n)`` adds to the attributes
of the current call's top span (graphs captured).
``spans()`` reads the store, ``summary()`` totals it by name,
``reset()`` clears it.

The store is a ``StepTimer``, the JAX package's named-phase aggregator:
``phase(name)`` is a span that records whatever the switch says, and
``summary()`` keeps the JAX package's format. A span is timed on the
host's clock with no device synchronize, as the JAX package's phase is
under its asynchronous dispatch: on the card it measures the host's work
of issuing the span's work (and any wait inside it), not the kernels'
time, which the device trace holds.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
import types
from collections import defaultdict
from functools import wraps
from typing import Dict, List, Optional

import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device

# whether an autograd / torch.profiler session is recording in this process
_profiler_enabled = torch._C._autograd._profiler_enabled


def timer(func):
    """Print the wall time of each call (parity: util/tool.py:203-213)."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        print("%s function cost: %fs" % (func.__name__, time.time() - start))
        return result

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str, device: DeviceLike = None):
    """Trace the enclosed work with ``torch.profiler``: the host's operators,
    the program's spans, and the card's kernels and copies when ``device``
    is a CUDA device (``None`` means cuda, and raises without one, as every
    entry point of the port). The span store is cleared when the trace
    starts, so that afterwards it holds the trace's spans (``summary()``).
    On exit the trace is written to
    ``<log_dir>/<hostname>_<pid>.<time_ns>.pt.trace.json``, the name
    ``torch.profiler.tensorboard_trace_handler`` gives, and the yielded
    namespace's ``path`` names it.

    A trace may lack some of the card's kernel records: the profiler on the
    card can lose records of a window, so a reader counts what it holds."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = types.SimpleNamespace(path=None)
    reset()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield out
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        out.path = os.path.join(log_dir, "%s_%d.%d.pt.trace.json"
                                % (socket.gethostname(), os.getpid(), time.time_ns()))
        prof.export_chrome_trace(out.path)


class Span:
    """One recorded span: ``name``, host ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``; ``end_ns`` None while it is open), its
    ``index`` in the store, its ``parent``'s index (None for a top span),
    ``call``, the index of the top span it lies in (its own for a top
    span), and ``attrs``, its attributes by name."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "call", "attrs")

    def __init__(self, name: str, index: int, parent: Optional["Span"], attrs: dict):
        self.name, self.index, self.attrs = name, index, attrs
        self.parent = None if parent is None else parent.index
        self.call = index if parent is None else parent.call
        self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Phase:
    """An open span of ``timer`` (see ``StepTimer.phase``)."""

    __slots__ = ("timer", "name", "attrs", "record", "range")

    def __init__(self, timer: "StepTimer", name: str, attrs: dict):
        self.timer, self.name, self.attrs = timer, name, attrs
        self.record = self.range = None

    def __enter__(self) -> Span:
        stack = self.timer._stack()
        records = self.timer.records
        rec = self.record = Span(self.name, len(records), stack[-1] if stack else None, self.attrs)
        records.append(rec)
        stack.append(rec)
        if _profiler_enabled():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = self.timer._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        self.timer.totals[rec.name] += rec.seconds
        self.timer.counts[rec.name] += 1
        return False


class StepTimer:
    """Aggregates named phase timings (host wall-clock), and keeps each
    phase as a ``Span`` in ``records``, nested by the thread that opened
    it.

    A phase is timed on the host's clock with no device synchronize, as the
    JAX package's is under its asynchronous dispatch: on the card it
    measures the time the host takes to issue the phase's work, not the
    kernels' time, unless the phase itself waits for the device. Under a
    running ``torch.profiler`` a phase is also a ``record_function`` range
    of the trace."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.records: List[Span] = []
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def phase(self, name: str, **attrs) -> _Phase:
        """A span ``name`` with ``attrs``, recorded here whenever it runs;
        entering it yields its ``Span``, whose ``attrs`` the caller may add
        to while it is open."""
        return _Phase(self, name, attrs)

    def count(self, **n: int) -> None:
        """Add each of ``n`` to the attribute of that name of the current
        thread's open top span, if one is open."""
        stack = self._stack()
        if stack:
            attrs = stack[0].attrs
            for key, value in n.items():
                attrs[key] = attrs.get(key, 0) + value

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.records.clear()
        self._stack().clear()

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                "%-20s %8.3fs over %d calls (%.2f ms/call)"
                % (
                    name,
                    self.totals[name],
                    self.counts[name],
                    1000.0 * self.totals[name] / max(self.counts[name], 1),
                )
            )
        return "\n".join(lines)


# the program's span store, and the depth of the open ``tracing()`` blocks
_STORE = StepTimer()
_forced = 0
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """The program's span ``name`` with ``attrs`` where tracing is on (a
    profiler runs, or inside ``tracing()``): entering it yields its
    ``Span``. Off, a context that does nothing and yields None, so a
    caller computes an attribute that costs anything only when it got a
    ``Span``."""
    if _forced or _profiler_enabled():
        return _Phase(_STORE, name, attrs)
    return _OFF


def count(**n: int) -> None:
    """Add each of ``n`` to the attributes of the current call's top span
    (``StepTimer.count``); nothing where no span is open."""
    if _forced or _profiler_enabled():
        _STORE.count(**n)


@contextlib.contextmanager
def tracing():
    """Record the program's spans in the store inside the block, with no
    profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> List[Span]:
    """The spans recorded since the last ``reset()``, in the order they
    opened."""
    return list(_STORE.records)


def summary() -> str:
    """The store's totals by span name, in ``StepTimer.summary``'s format."""
    return _STORE.summary()


def reset() -> None:
    """Clear the store."""
    _STORE.reset()
