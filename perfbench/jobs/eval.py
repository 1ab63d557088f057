"""Evaluation traffic: full-catalogue evaluations of every test user, as
``Trainer.evaluate`` makes them (``Evaluator.evaluate(model.predict,
params)``), back to back.

Set-up builds the model and the evaluator over the benchmark's split and
weights, with the top-K ids of each call kept (``record_ids``), and makes
``warm_calls`` calls: the first runs eagerly and captures the call's
program, the next replays it. The window makes calls until ``--seconds``
have passed; the rate is test users ranked over the window.

Once the window has closed and the program is freed, the reference
propagates the same weights in float64 and judges the last call's output:
each user's ranked ids against the reference's scores of every item not
consumed in training (``topk_gap``), and the call's Recall@K and NDCG@K
against the reference's of the same ids (``metric_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts, program, tracing
from perfbench.harness import Outcome
from perfbench.reference.common import Arith, judge_topk, ranking_metrics

BLOCK = 2048  # users a block of the reference's scores


def consumed_mask(train, users: np.ndarray, device) -> torch.Tensor:
    """(len(users), items) True at each user's train items."""
    sub = train[users]
    rows = np.repeat(np.arange(len(users)), np.diff(sub.indptr))
    mask = torch.zeros((len(users), train.shape[1]), dtype=torch.bool, device=device)
    mask[torch.from_numpy(rows).to(device), torch.from_numpy(sub.indices.astype(np.int64)).to(device)] = True
    return mask


def test_users(split) -> np.ndarray:
    """The users with test items, in ascending order: the rows of a call."""
    return np.flatnonzero(np.diff(split.test.indptr))


def reference_tables(ctx, split, arith: Arith):
    cfg = ctx.cell.config
    ref = program.reference(cfg)
    weights = program.weights(ctx, split.num_users, split.num_items)
    with torch.no_grad():
        return ref.propagate(weights, ref.graph(split.train, cfg["hyper"], ctx.device), cfg["hyper"], arith)


def reference_ids(ctx, split, users: np.ndarray, k: int, arith: Arith):
    """The reference's own top-``k`` ids (and scores) of ``users`` in
    ``arith``: the control's output."""
    u_t, i_t = reference_tables(ctx, split, arith)
    ids, vals = [], []
    with torch.no_grad():
        for lo in range(0, len(users), BLOCK):
            u = users[lo:lo + BLOCK]
            s = arith.mm(u_t[torch.from_numpy(u).to(ctx.device)], i_t.T)
            s = torch.where(consumed_mask(split.train, u, ctx.device), torch.full_like(s, -np.inf), s)
            top = torch.topk(s, k, dim=1)
            ids.append(top.indices.cpu().numpy())
            vals.append(top.values.float().cpu().numpy())
    return np.concatenate(ids), np.concatenate(vals)


def judge_blocks(ctx, split, users: np.ndarray, ids: np.ndarray, scores=None) -> dict:
    """``judge_topk`` of ``ids`` (one row a user of ``users``) over blocks,
    against the float64 reference: the worst of each number."""
    u_t, i_t = reference_tables(ctx, split, Arith("float64"))
    worst = {}
    with torch.no_grad():
        for lo in range(0, len(users), BLOCK):
            u = users[lo:lo + BLOCK]
            s = u_t[torch.from_numpy(u).to(ctx.device)] @ i_t.T
            got = judge_topk(ids[lo:lo + BLOCK], s, consumed_mask(split.train, u, ctx.device),
                             None if scores is None else scores[lo:lo + BLOCK])
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), v) if not np.isnan(v) else v
    return worst


def judge(ctx, evidence) -> dict:
    """The last call's ids and metrics against the reference."""
    split, ids, metrics = evidence
    users = test_users(split)
    k = int(ctx.cell.traffic["k"])
    out = judge_blocks(ctx, split, users, ids) if len(ids) == len(users) else {"topk_gap": float("inf")}
    truth = [split.test.indices[split.test.indptr[u]:split.test.indptr[u + 1]] for u in users]
    want = ranking_metrics(ids[:len(users)], truth, k).mean(0) if len(ids) >= len(users) else np.full(2, np.nan)
    out["metric_gap"] = float(max(abs(float(metrics[0]) - want[0]), abs(float(metrics[1]) - want[1])))
    return out


def setup(ctx):
    from neurec_tpu_torch.eval import Evaluator

    phases = program.Phases(ctx)
    split = program.load_split(ctx)
    phases.mark("split")
    prog = program.build(ctx, split)
    phases.mark("model")
    if [m.lower() for m in prog.conf.get("metric")] != ["recall", "ndcg"] or \
            list(prog.conf.get("topk")) != [int(ctx.cell.traffic["k"])]:
        raise ValueError("the evaluation job reads Recall@K and NDCG@K at the traffic's K alone")
    evaluator = Evaluator.from_dataset(prog.dataset, prog.conf, device=ctx.device)
    evaluator.evaluator.record_ids = True
    phases.mark("evaluator")
    params = program.weights(ctx, split.num_users, split.num_items)
    phases.mark("weights")
    for _ in range(int(ctx.cell.traffic["warm_calls"])):
        evaluator.evaluate(prog.model.predict, params)
    phases.mark("warm_calls")
    phases.report()
    return split, prog, evaluator, params


def traced_record(ctx, split, prog, evaluator, params):
    from torch.profiler import record_function

    from neurec_tpu_torch.ops.topk import top_k

    n = int(ctx.cell.traffic["traced_calls"])
    last = [None]
    program.sync(ctx.device)
    start = time.perf_counter()
    for _ in range(n):
        evaluator.evaluate(prog.model.predict, params)
    timed = {"wall_s": time.perf_counter() - start, "units": n}

    def calls():
        for _ in range(n):
            with record_function("evaluate"):
                last[0] = evaluator.evaluate(prog.model.predict, params)

    w = tracing.traced(calls, ("k1", "k2"), ctx.device)
    cfg, k = ctx.cell.config, int(ctx.cell.traffic["k"])
    hyper = cfg["hyper"]
    B, items = int(hyper["test_batch_size"]), split.num_items
    users = test_users(split)
    ref = program.reference(cfg)
    d = ref.width(hyper)
    with torch.no_grad():
        u = users[:B]
        scores = prog.model.predict(params, torch.from_numpy(u).to(ctx.device))
        scores = torch.where(consumed_mask(split.train, u, ctx.device), torch.full_like(scores, -np.inf), scores)
        probe_s = tracing.event_seconds(lambda: top_k(scores, k), int(ctx.cell.traffic["probe_calls"]))
    nnz, n_nodes = program.adjacency_nnz(cfg, split), split.num_users + split.num_items
    mc = counts.model(cfg["reference"])
    record = {
        "untraced": timed,
        "traced": {"window_s": w.window_s, "busy_s": w.busy_s, "units": n, "family_s": w.family_s,
                   "family_launches": w.family_launches, "dropped": w.dropped},
        "bounds": {"k1_launch_s": counts.bound_s(counts.k1_bytes(B, items, d), counts.k1_flops(B, items, d)),
                   "k2_launch_s": counts.bound_s(counts.spmm_bytes(n_nodes, nnz, mc.spmm_width(hyper))),
                   "topk_s": counts.bound_s(counts.topk_bytes(len(u), items, k))},
        "topk_probe_s": probe_s,
        "flops_per_unit": mc.propagate_flops(hyper, nnz, n_nodes) + mc.score_flops(hyper, len(users), items),
    }
    return record, w, last[0]


def measure(ctx):
    """(the outcome but its checks, the evidence the judge reads)."""
    split, prog, evaluator, params = setup(ctx)
    e2e = {"setup_s": time.perf_counter() - ctx.t0}
    n_users = len(evaluator.evaluator.test_users)
    if ctx.trace:
        record, w, result = traced_record(ctx, split, prog, evaluator, params)
        out = Outcome(e2e, record, record["untraced"]["units"], 0, 0, {}, w.busy_s, w.window_s,
                      tracing.breakdown(w))
    else:
        calls = 0
        start = time.perf_counter()
        while True:
            result = evaluator.evaluate(prog.model.predict, params)
            calls += 1
            elapsed = time.perf_counter() - start
            if elapsed >= ctx.seconds:
                break
        e2e["eval_users_per_s"] = calls * n_users / elapsed
        out = Outcome(e2e, None, calls, 0, 0, {})
    # the window's last call is judged: its ids and its metrics
    ids = evaluator.evaluator.last_ids[:n_users].cpu().numpy()
    metrics = [float(x) for x in result.split("\t")]
    out = out._replace(memory_peak_bytes=program.memory_peak(ctx.device))
    del evaluator, prog, params
    program.free()
    return out, (split, ids, metrics)


def run(ctx) -> Outcome:
    out, evidence = measure(ctx)
    return out._replace(checks=judge(ctx, evidence))
