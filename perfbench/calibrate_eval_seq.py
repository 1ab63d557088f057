"""The readings the limits of a sequential evaluation cell
(``perfbench/limits/<cell>.json``, kind ``eval_seq``) are set from, on the
card, at the cell's own size (the benchmark's runs never run this):

    python3 perfbench/calibrate_eval_seq.py --workload hstu_ml20m.eval_seq --seeds 11,12,... [--seconds 2]

For each seed, in one process: a run of the cell with a short window (the
program's sound readings, judged as every run is judged); then the
reference put in the program's place over every user, its ids and user
vectors judged the same way:

* ``control``: the reference in TF32, the precision just below the
  configuration's float32 with TF32 off, each user's metrics kept in
  bfloat16 (float32's nearest lower step for arithmetic that is no
  product);
* the faults, the reference in float32 with one planted
  (``reference/hstu.py``): ``time_bias`` (the time term left out),
  ``gate_ln`` (the gate's LayerNorm left out), ``half_layers`` (the first
  half of the layers alone).

An answer altered where it is produced reads infinite and needs no run.
Each seed prints one JSON line.
"""

import os
import sys
import time

if __name__ == "__main__":  # run as a file: the checkout's root leads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference.common import Arith  # noqa: E402
from perfbench.reference.hstu import FAULTS  # noqa: E402


def readings(ctx) -> dict:
    mod = harness.job("eval_seq")
    out, evidence = mod.measure(ctx)
    split, users, _, _, _, _ = evidence
    line = {"seed": ctx.seed, "end_to_end": out.end_to_end, "sound": mod.judge(ctx, evidence)}
    ks = [int(k) for k in ctx.cell.config["hyper"]["topk"]]
    everyone = np.arange(split.num_users)
    truth = mod.test_items(split)

    def in_place(arith, fault=None, bf16=False):
        ids, vectors = mod.reference_ids(ctx, split, everyone, max(ks), arith, fault)
        per_user = mod.loo_metrics(ids, truth, ks)
        if bf16:
            per_user = torch.from_numpy(per_user).to(torch.bfloat16).double().numpy()
        return mod.judge(ctx, (split, users, ids[users], vectors[users], ids, per_user.mean(0)))

    line["control"] = in_place(Arith("tf32"), bf16=True)
    for fault in FAULTS:
        line[fault] = in_place(Arith("float32"), fault)
    return line


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_eval_seq: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.ROOT, args.workload)
    if cell.traffic["kind"] != "eval_seq":
        print("calibrate_eval_seq: %s is no eval_seq cell" % args.workload, file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(harness.ROOT, cell, seed, args.seconds, False, torch.device("cuda"), t0)
        line = readings(ctx)
        line.update(workload=args.workload, seconds=time.perf_counter() - t0)
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
