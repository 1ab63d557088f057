"""Tracing / profiling utilities (port of ``neurec_tpu/profiling.py``).

The reference's only tracing is a wall-clock ``@timer`` decorator
(util/tool.py:203-213). That is kept for log parity, plus a
``torch.profiler`` trace context for device profiles (Chrome / Perfetto
JSON, which TensorBoard's profiler plugin also reads), and a per-phase
timing aggregator.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
import types
from collections import defaultdict
from functools import wraps
from typing import Dict

from neurec_tpu_torch.device import DeviceLike, resolve_device


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
    and the card's kernels and copies when ``device`` is a CUDA device
    (``None`` means cuda, and raises without one, as every entry point of
    the port). On exit the trace is written to
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


class StepTimer:
    """Aggregates named phase timings (host wall-clock).

    A phase is timed on the host's clock with no device synchronize, as the
    JAX package's is under its asynchronous dispatch: on the card it
    measures the time the host takes to issue the phase's work, not the
    kernels' time, unless the phase itself waits for the device."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

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
