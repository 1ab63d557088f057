"""The traced window: ``torch.profiler`` over a run of the cell's work,
read from its Chrome trace.

Spans are the benchmark's own ``record_function`` ranges around the calls
into the program (``draw``, ``run``, ``evaluate``, ``request``), inside one
range ``window``. The device's operations are the trace's kernels,
copies and sets. Its busy time is the union of their intervals inside the
window. A kernel family (K1, K2) is found by its kernels' names, and its
launches are checked against the program's own counts
(``ops/_build.py::LAUNCHES``): the card's profiler now and then loses a
window's kernel records, so a window whose counts disagree is opened
again, up to ``TRIES`` times, and the run fails rather than report from an
incomplete one.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRIES = 6

# kernel families: (the launch counts that add up to one family's launches,
# the substrings of its kernels' names, the substring of the one kernel a
# launch runs once)
FAMILIES = {
    "k1": (("masked_scores",), ("masked_scores",), "masked_scores"),
    "k2": (("plan_spmm", "plan_spmm_t"), ("span_spmm_kernel", "span_fixup_kernel"), "span_spmm_kernel"),
}


class Window(NamedTuple):
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]       # (name, start us, duration us) of device operations
    spans: List[Tuple[str, float, float]]     # (name, start us, duration us) of the benchmark's ranges
    start_us: float
    family_s: Dict[str, float]                # a family's device seconds
    family_launches: Dict[str, int]
    dropped: int                              # windows opened again


def union_s(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds covered by the union of ``(start us, end us)`` intervals,
    clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e6


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The ``(start us, end us)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def parse_trace(events: List[dict], families: Sequence[str]):
    """(window (start, end) us, device ops, spans, family seconds, family
    kernel counts) of a Chrome trace's events."""
    ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0))) for e in events
           if e.get("cat") in DEVICE_CATS and "ts" in e]
    spans = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
             if e.get("cat") == "user_annotation" and "ts" in e]
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("the trace holds no 'window' range")
    family_s, family_n = {}, {}
    for fam in families:
        _, names, once = FAMILIES[fam]
        family_s[fam] = sum(d for n, _, d in ops if any(k in n for k in names)) / 1e6
        family_n[fam] = sum(1 for n, _, _ in ops if once in n)
    return (win[0][1], win[0][1] + win[0][2]), ops, [s for s in spans if s[0] != "window"], family_s, family_n


def traced(fn: Callable[[], None], families: Sequence[str], device) -> Window:
    """``fn`` (which opens its own spans) under the profiler inside a
    ``window`` range, ending in a synchronize; opened again where a
    family's kernel records fall short of its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from neurec_tpu_torch.ops._build import LAUNCHES

    dropped = 0
    for _ in range(TRIES):
        before = dict(LAUNCHES)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("window"):
                fn()
                torch.cuda.synchronize(device)
        launched = {fam: sum(LAUNCHES[k] - before[k] for k in FAMILIES[fam][0]) for fam in families}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fin:
                events = json.load(fin)["traceEvents"]
        finally:
            os.remove(path)
        (lo, hi), ops, spans, family_s, family_n = parse_trace(events, families)
        if all(family_n[f] == launched[f] for f in families):
            busy = union_s([(t, t + d) for _, t, d in ops], lo, hi)
            return Window((hi - lo) / 1e6, busy, ops, spans, lo, family_s, launched, dropped)
        dropped += 1
        print("perfbench: a profiler window lost kernel records (%s of %s); opened again"
              % (family_n, launched), file=sys.stderr)
    raise RuntimeError("every profiler window lost kernel records (%d tries)" % TRIES)


def span_device_s(w: Window, name: str) -> float:
    """Device seconds of the operations that start inside a span ``name``."""
    spans = [(t, t + d) for n, t, d in w.spans if n == name]
    return sum(d for _, t, d in w.ops if any(a <= t < b for a, b in spans)) / 1e6


def breakdown(w: Window, top: int = 10) -> dict:
    """The device operations that took the most time (seconds, summed by
    name) and the longest idle gaps, each named by the benchmark's span
    the host was in at its middle (``outside`` where none)."""
    by_name: Dict[str, float] = {}
    for n, _, d in w.ops:
        short = n.removeprefix("void ").split("(")[0][:80]
        by_name[short] = by_name.get(short, 0.0) + d / 1e6
    lo, hi = w.start_us, w.start_us + w.window_s * 1e6
    gaps = idle_gaps([(t, t + d) for _, t, d in w.ops], lo, hi)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        inside = [n for n, t, d in w.spans if t <= mid < t + d]
        named.append([inside[-1] if inside else "outside", (b - a) / 1e6])
    return {"device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": named}


def event_seconds(fn, n: int) -> float:
    """Seconds a call of ``fn`` takes on the device: CUDA events around
    ``n`` calls after ``n`` warm ones."""
    import torch

    for _ in range(n):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n
