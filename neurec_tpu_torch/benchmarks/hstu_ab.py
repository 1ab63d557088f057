"""HSTU's attention kernel against its plain version and a library
composition, on the card.

    python -m neurec_tpu_torch.benchmarks.hstu_ab [--iters 10] [--seed 2024] [--out FILE]

At the evaluation's batch (2048, 200, 2, 25) and the training batch (128,
200, 2, 25), each over two sets of lengths (``cell``: 19 plus a lognormal
of median 48 and log sigma 1.38, capped at 200, the synthetic ML-20M
histories' train lengths; ``full``: every user at 200), on the same inputs:

* ``kernel``: ``ops/hstu.py::attention_kernel``, what the model runs on the
  card (``csrc/hstu_attention.cu``);
* ``plain``: ``attention_reference``, the plain version (the bias, its
  buckets and the mask computed, the N x N scores materialised);
* ``library``: ``torch.matmul`` products with the mask, the bias and mask
  computed once outside the timing: q k^T + bias, SiLU / N, the mask, A v.

Each has its CUDA-event time (``ms``, the mean of ``iters`` back-to-back
calls after as many warm ones) and its device time (``device_ms``, the
kernels' summed time under ``torch.profiler`` from a window in which every
kernel ran a whole number of times a call, or None). ``bound_ms`` is the
least time a call could take (q, k, v read once and the output written
once at the real positions alone, the tables, lengths and the real
positions' times read once; 2 h (dqk + dv) operations a causal pair at the
TF32 rate, or the bytes at the HBM rate, the larger);
``kernel_gap`` is the kernel's largest distance from the plain version
computed in float64, over the row's largest value, ``plain_gap`` the plain
version's own in float32.

The layer's passes around the attention (``layers``), at the evaluation's
(2048, 200, d 50, 2 heads of 25), on every row (a layer computes its pad
rows too): ``fused``, the kernels of ``csrc/hstu_layer.cu``
(``layer_in``: ``SiLU(LN(x) W1 + b1)``, ``layer_out``: ``x + (u * LN(attn))
W2 + b2``), against ``plain``, their plain versions (``layer_in_reference``,
``layer_out_reference``: LayerNorm's passes, a cuBLAS f32 GEMM, the
elementwise passes), each by CUDA events and device time; ``bound_ms``
their bytes read and written once at the HBM rate, ``f32_ms`` their
operations at the card's f32 FMA rate; ``gap`` and ``plain_gap`` each
one's largest distance from the plain version in float64, over the row's
largest value; ``max_abs_err`` the kernel's largest distance from the
plain version in float32.

Every kernel is held to its plain version as the card tests hold it: its
gap from float64 no more than twice the plain version's own in float32
(``gap_limit``), a limit that a NaN, an infinity or one TF32 pass fails.
It prints one JSON object with the card's name and power limit, and
exits 1 after it where a kernel is past its limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from neurec_tpu_torch.benchmarks.k1_widths import _events_ms, card
from neurec_tpu_torch.benchmarks.topk_ab import whole_window_device_ms
from neurec_tpu_torch.ops import hstu

HBM_BYTES_PER_S, TF32_FLOPS, F32_FLOPS = 3.35e12, 495e12, 67e12  # H100 SXM (NVIDIA data sheet)


def make_inputs(B, N, h, d, lengths, seed, device):
    g = torch.Generator().manual_seed(seed)
    buf = (torch.randn((B, N, 4 * h * d), generator=g) * 0.5).to(device)
    v = buf[..., h * d:2 * h * d].unflatten(-1, (h, d))
    q = buf[..., 2 * h * d:3 * h * d].unflatten(-1, (h, d))
    k = buf[..., 3 * h * d:].unflatten(-1, (h, d))
    gaps = torch.exp(torch.rand((B, N + 1), generator=g) * 16).long()
    ts = (10 ** 9 + torch.cumsum(gaps, 1)).to(device)
    w_p = (torch.randn(2 * N - 1, generator=g) * 0.02).to(device)
    w_t = (torch.randn(129, generator=g) * 0.02).to(device)
    return q, k, v, torch.from_numpy(lengths).to(device), ts, w_p, w_t


def bound_ms(B, N, h, d, lengths) -> tuple:
    """The attention's least time (module docstring) and what bounds it,
    ``bytes`` or ``flops``."""
    n = np.minimum(lengths.astype(np.int64), N)
    rows = float(np.sum(n))
    flops = 2.0 * h * (2 * d) * float(np.sum(n * (n + 1) // 2))
    n_bytes = 4.0 * rows * h * 3 * d + 4.0 * rows * h * d + 4.0 * B + 8.0 * (rows + B) + 4.0 * (2 * N + 128) \
        + 8.0 * 128
    by_bytes, by_flops = n_bytes / HBM_BYTES_PER_S, flops / TF32_FLOPS
    return 1e3 * max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "flops"


def gap_limit(plain_gap: float) -> float:
    """What a kernel's gap from float64 is held to: twice the float32
    plain version's own (and 1e-7, for a plain version that is exact)."""
    return 2 * plain_gap + 1e-7


def failures(report: dict) -> list:
    """The rows of ``run``'s report whose kernel is past its limit, or
    not finite."""
    rows = [(r["kernel"], r["gap"], r["gap_limit"]) for r in report["layers"]]
    rows += [("hstu_attn[%d,%s]" % (r["B"], r["lengths"]), r["kernel_gap"], r["gap_limit"])
             for r in report["shapes"]]
    return [row for row in rows if not (math.isfinite(row[1]) and row[1] <= row[2])]


def layer_rows(B, N, d, h, dqk, dv, iters, seed, device) -> list:
    """The two layer kernels beside their plain versions (module docstring)."""
    g = torch.Generator().manual_seed(seed)
    W, hv, rows = 2 * h * (dqk + dv), h * dv, B * N
    x = torch.randn((B, N, d), generator=g).to(device)
    w1 = (torch.randn((d, W), generator=g) * 0.02).to(device)
    b1 = (torch.randn((W,), generator=g) * 0.02).to(device)
    uvqk = hstu.layer_in_reference(x, w1, b1)
    attn = (torch.randn((B, N, hv), generator=g) * 0.1).to(device)
    w2 = (torch.randn((hv, d), generator=g) * (2.0 / (hv + d)) ** 0.5).to(device)
    b2 = (torch.randn((d,), generator=g) * 0.02).to(device)
    cases = [
        ("hstu_layer_in", (x, w1, b1), hstu.layer_in, hstu.layer_in_reference,
         4.0 * (rows * (d + W) + d * W + W), 2.0 * rows * d * W),
        ("hstu_layer_out", (attn, uvqk[..., :hv], x, w2, b2), hstu.layer_out, hstu.layer_out_reference,
         4.0 * (rows * (2 * hv + 2 * d) + hv * d + d), 2.0 * rows * hv * d),
    ]
    out = []
    for name, args, fused, plain, n_bytes, ops in cases:
        want = plain(*(t.double() for t in args))
        scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)

        def gap(got):
            return float(((got.double() - want).abs() / scale).max())
        got, ref32 = fused(*args), plain(*args)
        row = {"kernel": name, "B": B, "N": N, "d": d, "heads": h, "dqk": dqk, "dv": dv,
               "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S, "f32_ms": 1e3 * ops / F32_FLOPS,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "flops",
               "gap": gap(got), "plain_gap": gap(ref32), "max_abs_err": float((got - ref32).abs().max())}
        row["gap_limit"] = gap_limit(row["plain_gap"])
        del want, scale, got, ref32
        for label, fn in (("fused", fused), ("plain", plain)):
            row[label] = {"ms": _events_ms(lambda: fn(*args), iters),
                          "device_ms": whole_window_device_ms(lambda: fn(*args), iters)}
        row["fused_share_of_bound"] = row["bound_ms"] / row["fused"]["ms"]
        out.append(row)
        torch.cuda.empty_cache()
    return out


def run(iters: int = 10, seed: int = 2024) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("hstu_ab times the kernel on a CUDA card; none is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(seed)
    N, h, d = 200, 2, 25
    report = {"card": card(), "layers": layer_rows(2048, 200, 50, 2, 25, 25, iters, seed, dev), "shapes": []}
    for B in (2048, 128):
        cell = np.minimum(19 + np.floor(rng.lognormal(np.log(48), 1.38, B)), N).astype(np.int32)
        for name, lengths in (("cell", cell), ("full", np.full(B, N, np.int32))):
            q, k, v, lens, ts, w_p, w_t = make_inputs(B, N, h, d, lengths, seed, dev)
            bias = hstu.relative_bias(ts, w_p, w_t, N)[:, None]
            mask = hstu.causal_mask(lens, N)[:, None]
            qh, kt, vh = q.transpose(1, 2), k.permute(0, 2, 3, 1), v.transpose(1, 2)

            def library():
                s = torch.matmul(qh, kt) + bias
                a = torch.where(mask, F.silu(s) / N, torch.zeros_like(s))
                return torch.matmul(a, vh)

            calls = {
                "kernel": lambda: hstu.attention_kernel(q, k, v, lens, ts, w_p, w_t),
                "plain": lambda: hstu.attention_reference(q, k, v, lens, ts, w_p, w_t),
                "library": library,
            }
            got, ref32 = calls["kernel"](), calls["plain"]()
            want = hstu.attention_reference(q.double(), k.double(), v.double(), lens, ts, w_p.double(),
                                            w_t.double())
            scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)

            def gap(t):
                return float(((t.double() - want).abs() / scale).max())
            row = {"B": B, "N": N, "heads": h, "d": d, "lengths": name, "mean_length": float(lengths.mean()),
                   "kernel_gap": gap(got), "plain_gap": gap(ref32),
                   "max_abs_err": float((got - ref32).abs().max())}
            row["bound_ms"], row["bound_by"] = bound_ms(B, N, h, d, lengths)
            row["gap_limit"] = gap_limit(row["plain_gap"])
            del want, scale, got, ref32
            for label, fn in calls.items():
                row[label] = {"ms": _events_ms(fn, iters), "device_ms": whole_window_device_ms(fn, iters)}
            row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel"]["ms"]
            report["shapes"].append(row)
            torch.cuda.empty_cache()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = run(args.iters, args.seed)
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as fout:
            fout.write(text + "\n")
    bad = failures(report)
    if bad:
        print("hstu_ab: kernels past their limit from float64 (kernel, gap, limit): %s" % bad, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
