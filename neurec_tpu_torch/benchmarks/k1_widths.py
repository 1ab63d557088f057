"""K1 at the evaluation shape and chosen widths, beside cuBLAS, on the card.

    python neurec_tpu_torch/benchmarks/k1_widths.py [--widths 1 16 17 21 33 40 64] [--users 2048]
        [--items 38546] [--iters 50] [--seed 2024]

For each width d: K1's ``masked_scores_bits`` on randn factors, (users, d)
and (items, d), drawn from a numpy seed, with the bit-plane mask of 8
random train items a user at the evaluator's width for the catalogue
(``eval/tiers.py::global_bits_width``). Beside it, on the same inputs,
cuBLAS's product alone (``matmul``: less work, no mask) and matmul +
``where`` on a prebuilt int8 mask (K1's function). Each is the mean of
``iters`` back-to-back calls, timed with CUDA events after as many calls
of warm-up. K1's output is held against its plain version: -inf at the
same places, the rest within 1e-5 of |u_b| |item_i|.

Run as a file, the script imports the ``neurec_tpu_torch`` that stands
first on ``PYTHONPATH``, so one command can time two checkouts' K1 in turn,
A, B, B, A (the report names the package's path and the card):

    PYTHONPATH=<checkout> python neurec_tpu_torch/benchmarks/k1_widths.py

It prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import neurec_tpu_torch
from neurec_tpu_torch.eval.tiers import global_bits_width
from neurec_tpu_torch.ops import masked_scores as k1

TRAIN_ITEMS = 8  # train items a user in the mask


def _events_ms(fn, iters: int) -> float:
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card() -> Optional[str]:
    """``name, power limit`` as nvidia-smi gives them, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(widths: Sequence[int], users: int, items: int, iters: int, seed: int) -> Dict[str, object]:
    if not torch.cuda.is_available():
        raise RuntimeError("k1_widths times K1 on a CUDA card; none is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # cuBLAS in f32, as the plain version
    rng = np.random.RandomState(seed)
    width = global_bits_width(items)
    train_rows = torch.from_numpy(rng.randint(0, items, (users, TRAIN_ITEMS)).astype(np.int32)).to(dev)
    bits = k1.pack_train_bits(train_rows, items, block_items=width)
    mask8 = k1.build_train_mask(train_rows, items)
    rows: List[Dict[str, object]] = []
    for d in widths:
        u = torch.from_numpy(rng.standard_normal((users, d)).astype(np.float32)).to(dev)
        it = torch.from_numpy(rng.standard_normal((items, d)).astype(np.float32)).to(dev)
        got = k1.masked_scores_bits(u, it, bits, width, items)
        want = k1.masked_scores_bits_reference(u, it, bits, width, items)
        finite = torch.isfinite(want)
        diff = (got - want)[finite].abs()
        scaled = float((diff / (u.norm(dim=1)[:, None] * it.norm(dim=1)[None, :])[finite]).max())
        if not torch.equal(torch.isinf(got), ~finite) or scaled > 1e-5:
            raise RuntimeError("K1 at d %d differs from its plain version: %g scaled" % (d, scaled))
        rows.append({
            "d": d, "max_abs_err": float(diff.max()), "max_scaled_err": scaled,
            "k1_ms": _events_ms(lambda: k1.masked_scores_bits(u, it, bits, width, items), iters),
            "matmul_ms": _events_ms(lambda: torch.matmul(u, it.T), iters),
            "matmul_where_ms": _events_ms(
                lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u, it.T)), iters),
        })
        del u, it, got, want
    return {"package": neurec_tpu_torch.__file__, "card": card(), "users": users, "items": items,
            "bits_width": width, "iters": iters, "seed": seed, "widths": rows}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[1, 16, 17, 21, 33, 40, 64])
    ap.add_argument("--users", type=int, default=2048)
    ap.add_argument("--items", type=int, default=38546)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args(argv)
    report = run(args.widths, args.users, args.items, args.iters, args.seed)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
