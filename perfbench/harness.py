"""One run of one cell: find its files by the names ``BENCHMARK.json``
gives, run its traffic's job, judge what the timed path produced, and
print the result line.

A cell names a configuration (``configs[].file``: model, hyperparameters,
data, reference) and a traffic mix (``perfbench/traffic/<traffic>.json``,
whose ``kind`` names the job in ``perfbench/jobs/``). Its limits are
``perfbench/limits/<cell>.json``; its per-layer metrics are read by
``perfbench/layer_metrics/<metric>.py``, or by the file of the part of
the metric's name before its first dot. A later cell adds files and
entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import traceback
from typing import Callable, Dict, List, NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference package, its JAX stack and Flax: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "neurec_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict     # the configuration's file
    traffic: dict    # the traffic mix's file
    limits: dict     # number compared -> its limit
    end_to_end: List[dict]  # the manifest's entries this cell reports
    per_layer: List[dict]


class Context(NamedTuple):
    root: str
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float       # perf_counter at the process's start


class Outcome(NamedTuple):
    """What a job hands back: the end-to-end values it measured (by
    metric name), the record the per-layer readers read (trace runs), the
    work attempted and failed, the peak memory, the numbers compared, and
    the trace's busy and window seconds and breakdown."""

    end_to_end: Dict[str, float]
    record: Optional[dict]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is a forbidden one, compared
    whole (``neurec_tpu_torch`` is not ``neurec_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _load_json(path: str) -> dict:
    with open(path) as fin:
        return json.load(fin)


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json (%s)" % (workload, ", ".join(sorted(cells))))
    w = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = os.path.join(root, "perfbench")
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_load_json(os.path.join(root, config["file"])),
        traffic=_load_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(bench, "limits", workload + ".json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def layer_reader(root: str, metric: str) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``perfbench/layer_metrics/<metric>.py``, else of
    the file of the name before its first dot (``mfu.train`` and
    ``mfu.eval`` share ``mfu.py``)."""
    folder = os.path.join(root, "perfbench", "layer_metrics")
    path = os.path.join(folder, metric + ".py")
    if not os.path.isfile(path):
        path = os.path.join(folder, metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_layer_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def job(kind: str):
    """The job of a traffic mix's ``kind``: ``perfbench/jobs/<kind>.py``."""
    return importlib.import_module("perfbench.jobs." + kind)


def judged(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers the cell's limits name, each beside its limit; a limit
    whose number the job did not produce is refused."""
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise KeyError("no number %s to compare" % ", ".join(missing))
    return {name: {"value": checks[name], "limit": limits[name]} for name in limits}


def is_correct(checks: Dict[str, dict]) -> bool:
    # NaN compares false: a number that is not one fails
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Run the cell and return its result line (a dict, ``checks`` last)."""
    import torch

    cell = load_cell(root, workload)
    ctx = Context(root, cell, int(seed), float(seconds), bool(trace), torch.device(device), t0)
    out: Outcome = job(cell.traffic["kind"]).run(ctx)
    checks = judged(out.checks, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = layer_reader(root, m["name"])(out.record)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: out.end_to_end[m["name"]] for m in cell.end_to_end}
    cuda = ctx.device.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    line = {
        "correct": is_correct(checks),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {name: {"value": v, "unit": units[name]} for name, v in values.items()},
        "device": device_info,
    }
    if trace:
        device_info.update(busy_s=out.busy_s, window_s=out.window_s)
        if out.breakdown is not None:
            line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    try:
        import torch

        cell = load_cell(ROOT, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print("perfbench: the cell needs %d CUDA device(s); %s" % (
                cell.chips, "none is available" if not torch.cuda.is_available()
                else "%d found" % torch.cuda.device_count()), file=sys.stderr)
            return 2
        line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print("perfbench: forbidden modules loaded: %s" % ", ".join(found), file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(line, allow_nan=True))
    return 0
