"""The top-K kernel against the composition it replaced, and the exact
segment top-K, on the card.

    python -m neurec_tpu_torch.benchmarks.topk_ab [--users 2048] [--items 38546] [--ks 20 50]
        [--iters 20] [--seed 2024] [--out FILE]

At an evaluation batch of gowalla's catalogue (2048 x 38,546 f32 scores by
default), for each input and each K, these calls on the same scores:

* ``top_k``: ``ops/topk.py::top_k``, what the evaluator runs: the kernel
  (``csrc/topk.cu``) on the path it took for the row length (``path``; None
  on the CPU, where ``top_k`` is the plain version);
* ``top_k_plain``: ``top_k_reference``, the composition the kernel replaced
  (``torch.topk`` of order keys and the tie fix-up), run on the card;
* ``exact``: ``ops/fast_topk.py::exact_topk_indices`` (segment maxima,
  hot segments, a ``top_k`` of the gathered ones);
* ``rowmax``: ``x.amax(dim=1)``, one read of the scores: the floor any
  top-K stands on (``read_floor_ms``, the bytes over the card's HBM rate).

And the plain version's parts, the numbers from before the kernel:
``torch_topk``, the library call (``torch.topk`` of the values, no order
among ties), which ``top_k_plain`` runs on its order keys; ``tie_cumsum``,
the full-row running count of the ties at the K-th key of its fix-up;
``exact_rerank``, the ``top_k`` of the gathered hot segments, (B, max_hot *
seg), that ends ``exact``.

Each has its CUDA-event time (``ms``, the mean of ``iters`` back-to-back
calls after as many of warm-up) and its device time (``device_ms``, the
kernels' summed time under ``torch.profiler`` from a window in which every
kernel ran a whole number of times a call, or None where none was whole).
``kernel_equal`` says whether the kernel's values and ids equal the plain
version's, bit for bit; ``exact`` has its ``overflow`` (rows with more than
``max_hot`` hot segments) and whether its ids equal ``top_k``'s
(``ids_equal``; required wherever ``overflow`` is 0).

The inputs: ``randn`` from the numpy seed here; ``chip_smoke.py`` also
hands in a batch of K1's masked scores of the trained north star. It
prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from neurec_tpu_torch.benchmarks.k1_widths import _events_ms, card
from neurec_tpu_torch.ops.fast_topk import exact_topk_indices
from neurec_tpu_torch.ops import _build
from neurec_tpu_torch.ops.topk import PATHS, order_key, top_k, top_k_reference

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def whole_window_device_ms(fn: Callable, n: int = 20, tries: int = 6) -> Optional[float]:
    """The device time of one call of ``fn``: its kernels' summed time over
    ``n`` calls under ``torch.profiler``, per call, from the first of
    ``tries`` windows whose kernels all ran a whole number of times a call
    (a window on the card can lose kernel records); None if none was."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if kernels and all(e.count % n == 0 for e in kernels):
            return sum(e.self_device_time_total for e in kernels) / n / 1e3
    return None


def run(inputs: Dict[str, torch.Tensor], ks: Sequence[int] = (20, 50), iters: int = 20,
        device_ms: Callable = whole_window_device_ms) -> dict:
    """The calls on each (B, I) f32 input at each K (module docstring);
    raises where ``exact`` reports no overflow and its ids differ."""
    report = {}
    for name, x in inputs.items():
        B, I = x.shape
        floor = B * I * 4 / PEAK_BYTES_PER_S * 1e3
        for k in ks:
            before = dict(_build.LAUNCHES)
            got, plain = top_k(x, k), top_k_reference(x, k)
            path = [p for p in PATHS if _build.LAUNCHES["topk_" + p] > before["topk_" + p]]
            kernel_equal = bool(torch.equal(got[1], plain[1]) and
                                torch.equal(got[0].view(torch.int32), plain[0].view(torch.int32)))
            want = got[1]
            idx, overflow = exact_topk_indices(x, k)
            overflow = int(overflow)
            differ = int((idx.long() != want).any(dim=1).sum())
            if overflow == 0 and differ:
                raise AssertionError("%s, k %d: exact_topk_indices differs from top_k on %d rows with no overflow"
                                     % (name, k, differ))
            key = order_key(x)
            t = torch.topk(key, k, dim=-1).values.amin(-1, keepdim=True)
            hot = x[:, : 64 * 128].contiguous()  # the re-rank's shape (max_hot 64, seg 128)
            calls = {"top_k": lambda x=x, k=k: top_k(x, k),
                     "top_k_plain": lambda x=x, k=k: top_k_reference(x, k),
                     "exact": lambda x=x, k=k: exact_topk_indices(x, k),
                     "rowmax": lambda x=x: x.amax(dim=1),
                     "torch_topk": lambda x=x, k=k: torch.topk(x, k, dim=-1),
                     "tie_cumsum": lambda key=key, t=t: torch.cumsum(key == t, dim=-1, dtype=torch.int32),
                     "exact_rerank": lambda hot=hot, k=k: top_k(hot, k)}
            rec = {"shape": [B, I], "k": k, "read_bytes": B * I * 4, "read_floor_ms": floor,
                   "path": path[0] if path else None, "kernel_equal": kernel_equal, "overflow": overflow,
                   "ids_equal": differ == 0, "rows_differing": differ}
            for call, fn in calls.items():
                rec[call] = {"ms": _events_ms(fn, iters), "device_ms": device_ms(fn)}
            report["%s/k%d" % (name, k)] = rec
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", type=int, default=2048)
    p.add_argument("--items", type=int, default=38546)
    p.add_argument("--ks", type=int, nargs="+", default=[20, 50])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("topk_ab: no CUDA device")
    rng = np.random.RandomState(args.seed)
    x = torch.from_numpy(rng.standard_normal((args.users, args.items)).astype(np.float32)).cuda()
    report = {"card": card(), "results": run({"randn": x}, args.ks, args.iters)}
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as fout:
            fout.write(text + "\n")
    print(text)
    return report


if __name__ == "__main__":
    main()
