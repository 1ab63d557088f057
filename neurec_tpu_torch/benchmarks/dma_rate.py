"""K4: how fast small copies to dynamic offsets can be issued, on the card.

    python -m neurec_tpu_torch.benchmarks.dma_rate [--n 65536] [--repeat 8] [--rounds 3] [--out FILE]

The counterpart of the JAX package's TPU probe ``benchmarks/dma_rate.py``,
measuring the same quantity: copies of a ``(rows, 128)`` f32 tile held on
chip, rows in {1, 4, 16} (512 B, 2 KB, 8 KB), to dynamic row offsets of a
``(65536, 128)`` f32 buffer in device memory; ``n`` int32 offsets cycled
over ``n * repeat`` copies, serial (each copy waited for) or with 8 in
flight. The kernel is ``csrc/dma_rate.cu`` (one block, the tile in shared
memory, one thread issuing bulk copies). Each call is timed with CUDA
events; a one-copy run of the same kernel is the floor, and the rate is
``n * repeat`` over (the fastest of ``rounds`` calls minus the fastest
floor). Every call gets offsets it has not seen, drawn from a numpy seed.

``dma_copies`` launches the kernel on a CUDA buffer; on a CPU buffer it
runs the plain version, ``index_fill_`` of the written rows. The report
keeps the JAX probe's fields (``dmas_per_s``, ``effective_GBps``,
``floor_s``, ``n_dmas_per_call``) and states the card's name and power
limit beside them. It is printed as JSON, and written to a file only where
``--out`` says (never under ``benchmarks/``, which holds the TPU record).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.ops import _build

OUT_ROWS = 1 << 16  # rows of the target buffer
COLS = 128          # f32 columns of a row: 512 B
ROWS_LIST = (1, 4, 16)
MODES = ("serial", "pipelined")
N_OUTSTANDING = 8   # copies in flight in the pipelined mode (fixed in the kernel)


def new_buffer(device: DeviceLike = None, fill: Optional[float] = 0.0) -> torch.Tensor:
    """The ``(65536, 128)`` f32 target buffer (uninitialized if ``fill`` is None)."""
    dev = resolve_device(device)
    if fill is None:
        return torch.empty((OUT_ROWS, COLS), dtype=torch.float32, device=dev)
    return torch.full((OUT_ROWS, COLS), fill, dtype=torch.float32, device=dev)


def _written_rows(offs: torch.Tensor, n_dma: int, rows: int) -> torch.Tensor:
    used = offs[: min(int(offs.numel()), n_dma)].long()
    return (used[:, None] + torch.arange(rows, device=offs.device)).reshape(-1)


def dma_copies_reference(offs: torch.Tensor, n_dma: int, rows: int) -> torch.Tensor:
    """Plain version: a zeroed buffer with 1.0 in every row the copies write."""
    out = new_buffer(offs.device)
    return out.index_fill_(0, _written_rows(offs, n_dma, rows), 1.0)


def dma_copies(offs: torch.Tensor, n_dma: int, rows: int, mode: str, out: torch.Tensor) -> torch.Tensor:
    """K4: ``n_dma`` copies of a ``(rows, 128)`` tile of 1.0 into ``out``
    at rows ``offs[k % n]`` .. + rows - 1; ``mode`` serial or pipelined.
    Returns ``out``; rows no copy writes keep what they held."""
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (MODES, mode))
    if rows not in ROWS_LIST:
        raise ValueError("rows must be one of %s, got %d" % (ROWS_LIST, rows))
    if offs.dtype != torch.int32 or offs.dim() != 1 or not offs.numel():
        raise TypeError("offs must be a non-empty 1-D int32 tensor")
    if out.shape != (OUT_ROWS, COLS) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError("out must be a contiguous (%d, %d) float32 buffer" % (OUT_ROWS, COLS))
    if offs.device != out.device:
        raise ValueError("offs on %s, out on %s" % (offs.device, out.device))
    if out.device.type == "cpu":
        return out.index_fill_(0, _written_rows(offs, n_dma, rows), 1.0)
    if out.device.type != "cuda":
        raise ValueError("dma_copies runs on cuda or cpu, not %s" % out.device)
    offs = offs.contiguous()
    lib = _build.load("dma_rate", out.device)
    fn = lib.neurec_dma_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(out.device):
        code = fn(offs.data_ptr(), offs.numel(), n_dma, rows, int(mode == "serial"), out.data_ptr(),
                  torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, code, "dma_rate")
    _build.LAUNCHES["dma_rate_" + mode] += 1
    return out


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_seconds(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure(n: int = 65536, repeat: int = 8, rounds: int = 3, rows_list: Sequence[int] = ROWS_LIST,
            device: DeviceLike = None, seed: int = 0) -> Dict[str, dict]:
    """The probe: per (rows, mode) the call times, the floor and the rate,
    variants interleaved round by round, on the card only."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures a CUDA device, not %s" % dev)
    n_total = n * repeat
    rng = np.random.RandomState(seed)
    out = new_buffer(dev, fill=None)

    def fresh(rows):
        return torch.from_numpy(rng.randint(0, OUT_ROWS - rows, n).astype(np.int32)).to(dev)

    variants = {}
    for rows in rows_list:
        for mode in MODES:
            variants[(rows, mode)] = (mode, n_total, [fresh(rows) for _ in range(rounds)])
        variants[(rows, "floor")] = ("serial", 1, [fresh(rows) for _ in range(rounds)])
    for (rows, _), (mode, count, pool) in variants.items():  # first calls: load and warm
        dma_copies(pool[0], count, rows, mode, out)
    torch.cuda.synchronize(dev)

    times = {k: [] for k in variants}
    for r in range(rounds):
        for (rows, kind), (mode, count, pool) in variants.items():
            times[(rows, kind)].append(_event_seconds(lambda: dma_copies(pool[r], count, rows, mode, out)))

    results = {}
    for rows in rows_list:
        floor = min(times[(rows, "floor")])
        for mode in MODES:
            t = min(times[(rows, mode)]) - floor
            rate = n_total / max(t, 1e-12)
            results["%dB_%s" % (rows * 512, mode)] = {
                "rounds_s": times[(rows, mode)],
                "floor_rounds_s": times[(rows, "floor")],
                "s_per_call_min": min(times[(rows, mode)]),
                "floor_s": floor,
                "n_dmas_per_call": n_total,
                "dmas_per_s": rate,
                "effective_GBps": rate * rows * 512 / 1e9,
            }
    results["meta"] = {
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line(),
        "n_offsets": n, "repeat": repeat, "rounds": rounds, "n_outstanding": N_OUTSTANDING,
        "protocol": "fresh offsets per call, variants interleaved, CUDA-event time per call, "
                    "min over rounds minus the min one-copy floor",
    }
    return results


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536, help="distinct offsets")
    ap.add_argument("--repeat", type=int, default=8, help="cycles over the offsets: n * repeat copies a call")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON report to this file")
    args = ap.parse_args(argv)
    if args.out:
        bench = os.path.join(os.path.dirname(_build.PACKAGE_DIR), "benchmarks")
        if os.path.commonpath([os.path.abspath(args.out), bench]) == bench:
            raise SystemExit("--out must not write under %s (the TPU probe's records)" % bench)
    results = measure(args.n, args.repeat, args.rounds)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as fout:
            json.dump(results, fout, indent=1)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
