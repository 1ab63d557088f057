"""How many of a window's kernel launches ``torch.profiler`` records, on the card.

    python -m neurec_tpu_torch.benchmarks.profiler_windows [--windows 10] [--calls 20] [--out FILE]

A device time read from ``torch.profiler`` is the sum of the kernel records
of a window; a window that loses records reads low, or reads nothing. For
each call below and each way of opening the window, ``--windows`` windows
of ``--calls`` back-to-back calls each (one kernel launch a call), and for
every window the kernel records against the launches made. The calls, on
inputs drawn from a numpy seed:

* ``k1_small``: K1 (``masked_scores_bits``) at SpectralCF's evaluation
  shape, 943 x 1,682 at d 300 (~0.03 ms a call);
* ``k1_gowalla``: K1 at gowalla's, 2048 x 38,546 at d 16 (~0.2 ms);
* ``matmul``: cuBLAS's product at gowalla's shape, d 16.

The ways (``WAYS``): ``plain`` (CPU and CUDA activities, the calls, a
synchronize, the window closed: ``chip_smoke.py``'s window before this
probe), ``cuda_only`` (the same, the device alone), ``warmup`` (the
profiler's schedule: one traced step of the same calls dropped first),
``warmup_sleep`` (``warmup``, then 50 ms idle before the step closes),
``long`` (``plain`` over 10x the calls).

It prints one JSON object: per call and way, the recorded share of the
launches over all windows, the windows that recorded every launch, those
that recorded none, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from neurec_tpu_torch.benchmarks.k1_widths import card
from neurec_tpu_torch.eval.tiers import global_bits_width
from neurec_tpu_torch.ops import masked_scores as k1

WAYS = ("plain", "cuda_only", "warmup", "warmup_sleep", "long")


def _calls(seed: int) -> Dict[str, Callable[[], torch.Tensor]]:
    rng = np.random.RandomState(seed)
    out = {}
    for name, (B, I, d) in (("k1_small", (943, 1682, 300)), ("k1_gowalla", (2048, 38546, 16))):
        u = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).cuda()
        items = torch.from_numpy(rng.standard_normal((I, d)).astype(np.float32)).cuda()
        width = global_bits_width(I)
        rows = torch.from_numpy(rng.randint(0, I, (B, 8)).astype(np.int32)).cuda()
        bits = k1.pack_train_bits(rows, I, block_items=width)
        out[name] = (lambda u=u, items=items, bits=bits, width=width, I=I:
                     k1.masked_scores_bits(u, items, bits, width, I))
        if name == "k1_gowalla":
            out["matmul"] = lambda u=u, items=items: torch.matmul(u, items.T)
    return out


def _window(fn: Callable, calls: int, way: str) -> Dict[str, int]:
    """Kernel name -> records of one window opened ``way``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if way == "cuda_only" else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = calls * (10 if way == "long" else 1)
    torch.cuda.synchronize()
    if way in ("warmup", "warmup_sleep"):
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                if way == "warmup_sleep":
                    time.sleep(0.05)
                prof.step()
    else:
        with profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=10)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = _calls(args.seed)
    report = {"card": card(), "windows": args.windows, "calls": args.calls, "results": {}}
    for name, fn in calls.items():
        fn()  # each call launches one kernel: K1's, or cuBLAS's product
        for way in WAYS:
            n = args.calls * (10 if way == "long" else 1)
            shares, whole, empty, seen = [], 0, 0, set()
            for _ in range(args.windows):
                got = _window(fn, args.calls, way)
                seen |= set(got)
                recorded = min(sum(got.values()), n)
                shares.append(recorded / n)
                whole += recorded == n
                empty += recorded == 0
            report["results"]["%s/%s" % (name, way)] = {
                "recorded_share": float(np.mean(shares)), "min_share": float(np.min(shares)),
                "whole_windows": whole, "empty_windows": empty, "kernels": sorted(seen)}
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as fout:
            fout.write(text + "\n")
    print(text)
    return report


if __name__ == "__main__":
    main()
