"""The readings the limits of ``perfbench/limits/<cell>.json`` are set
from, on the card, at the cell's own size (the benchmark's runs never run
this):

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... [--seconds 2]

For each seed, in one process: a run of the cell with a short window (the
program's sound readings, judged as every run is judged); the control,
the reference put in the program's place and computed in TF32, the
precision just below the configuration's float32 with TF32 off, its
output judged the same way; and the faults a cell can have, planted in
the reference put in the program's place:

* training: half of each batch left out, the loss over the rest scaled
  to the whole batch (``half_batch``), in the checked steps and the
  checked epoch; a state left unchanged reads 1 and needs no run;
* evaluation: the metrics taken over half of the users (``half_users``);
  the control keeps each user's metrics in bfloat16, float32's nearest
  lower step for arithmetic that is no product;
* every cell: an answer altered where it is produced reads infinite and
  needs no run.

Each seed prints one JSON line.
"""

import os
import sys
import time

if __name__ == "__main__":  # run as a file: the checkout's root leads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import json  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference.common import Arith, ranking_metrics  # noqa: E402

TF32 = Arith("tf32")


def half_batch(batch):
    w = batch["w"].clone()
    half = w.shape[0] // 2
    w[half:] = 0
    return dict(batch, w=2 * w)


def readings(ctx) -> dict:
    kind = ctx.cell.traffic["kind"]
    mod = harness.job(kind)
    out, evidence = mod.measure(ctx)
    line = {"seed": ctx.seed, "end_to_end": out.end_to_end}
    if kind == "train":
        split, checked, epoch = evidence
        ref, ref_e = mod.reference_steps(ctx, split, checked), mod.reference_steps(ctx, split, epoch)

        def numbers(arith=None, fault=None):
            kw = dict(fault=fault) if arith is None else dict(arith=arith)
            return dict(mod.compare(mod.reference_steps(ctx, split, checked, **kw), ref),
                        **mod.compare_epoch(mod.reference_steps(ctx, split, epoch, **kw), ref_e))

        line["sound"] = dict(mod.compare(checked, ref), **mod.compare_epoch(epoch, ref_e),
                             draw_faults=float(mod.judge_draws(split, checked) + mod.judge_draws(split, epoch)))
        line["leaves"] = {"/".join(map(str, p)): [checked["grad1"][p], ref["grad1"][p], checked["change"][p],
                                                   ref["change"][p]] for p in ref["grad1"]}
        line["epoch_leaves"] = {"/".join(map(str, p)): [epoch["moment"][p], ref_e["moment"][p], epoch["change"][p],
                                                         ref_e["change"][p]] for p in ref_e["moment"]}
        line["losses"] = [checked["losses"], ref["losses"], [epoch["loss"], ref_e["loss"]]]
        line["control"] = numbers(TF32)
        line["half_batch"] = numbers(fault=half_batch)
        # the reference against itself: float32 again, its sums in another
        # order on the card (atomic adds), over the checked epoch
        line["reference_again"] = mod.compare_epoch(mod.reference_steps(ctx, split, epoch), ref_e)
    elif kind == "eval":
        line["sound"] = mod.judge(ctx, evidence)
        split, ids, metrics = evidence
        users = mod.test_users(split)
        k = int(ctx.cell.traffic["k"])
        truth = [split.test.indices[split.test.indptr[u]:split.test.indptr[u + 1]] for u in users]
        c_ids, _ = mod.reference_ids(ctx, split, users, k, TF32)
        # its metrics as float32's nearest lower step would keep them: each
        # user's in bfloat16
        per_user = torch.from_numpy(ranking_metrics(c_ids, truth, k)).to(torch.bfloat16).double().numpy()
        line["control"] = mod.judge(ctx, (split, c_ids, per_user.mean(0)))
        half = len(users) // 2
        line["half_users"] = mod.judge(ctx, (split, ids, ranking_metrics(ids[:half], truth[:half], k).mean(0)))
    else:
        line["sound"] = mod.judge(ctx, evidence)
        split, users, ids, scores = evidence
        from perfbench.jobs.eval import reference_ids

        c_ids, c_scores = reference_ids(ctx, split, users, int(ctx.cell.traffic["k"]), TF32)
        line["control"] = mod.judge(ctx, (split, users, c_ids, c_scores))
    return line


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(harness.ROOT, cell, seed, args.seconds, False, torch.device("cuda"), t0)
        line = readings(ctx)
        line.update(workload=args.workload, seconds=time.perf_counter() - t0)
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
