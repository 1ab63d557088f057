"""Serving traffic: top-K requests through ``recommend.batch_topk``, a
closed loop of one client.

A request is ``request_users`` users drawn without replacement, each with
probability proportional to its train interactions (active users come
back more): the Gumbel top-k of log(degree) plus Gumbel noise, from
``--seed``. Set-up draws a pool of ``pool_requests`` requests, one draw of
the noise a chunk of requests, and sends ``warm_requests`` times a request
of each consumed-edge bucket the pool holds (a batch's consumed edges,
padded to a power of two, at least 8, is what the export's kept programs
are keyed by): the first captures the bucket's program, the next is its
graphs' first launch, which uploads them (~0.1 s). The window sends the pool's requests in turn until
``--seconds`` have passed: the rate is users served over the window, the
tail the 95th percentile of every request's latency.

``checked_requests`` of the window's requests, a uniform sample drawn from
the seed (a reservoir, whatever their count), are judged once the program
is freed: each user's ranked ids and returned scores against the float64
reference's scores of every item the user has not consumed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts, program, tracing
from perfbench.harness import Outcome
from perfbench.jobs.eval import consumed_mask, judge_blocks

CHUNK = 64  # requests a draw of the Gumbel noise


def request_pool(train, n_requests: int, n_users: int, seed: int) -> np.ndarray:
    """(n_requests, n_users) int32: each row users drawn without
    replacement with probability proportional to their train degree."""
    deg = np.diff(train.indptr).astype(np.float64)
    logw = np.where(deg > 0, np.log(np.maximum(deg, 1e-300)), -np.inf)
    rng = np.random.default_rng(seed)
    rows = []
    for lo in range(0, n_requests, CHUNK):
        keys = logw + rng.gumbel(size=(min(CHUNK, n_requests - lo), len(deg)))
        top = np.argpartition(-keys, n_users - 1, axis=1)[:, :n_users]
        rows.append(np.take_along_axis(top, np.argsort(-np.take_along_axis(keys, top, 1), axis=1), 1))
    return np.concatenate(rows).astype(np.int32)


def edge_bucket(train, users: np.ndarray, batch: int) -> int:
    """The padded consumed-edge count of a request's batches: the largest
    batch's train pairs rounded up to a power of two, at least 8."""
    deg = np.diff(train.indptr)[users]
    most = max(int(deg[lo:lo + batch].sum()) for lo in range(0, len(users), batch))
    return max(1 << max(most - 1, 0).bit_length(), 8)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng(seed), 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def setup(ctx):
    from neurec_tpu_torch.recommend import batch_topk

    t = ctx.cell.traffic
    phases = program.Phases(ctx)
    split = program.load_split(ctx)
    phases.mark("split")
    prog = program.build(ctx, split)
    phases.mark("model")
    params = program.weights(ctx, split.num_users, split.num_items)
    phases.mark("weights")
    pool = request_pool(split.train, int(t["pool_requests"]), int(t["request_users"]), ctx.seed)
    phases.mark("requests")

    def request(users):
        return batch_topk(prog.model, params, int(t["k"]), users=users, train_matrix=split.train,
                          batch_size=int(t["batch_size"]), device=ctx.device)

    seen = set()
    for users in pool:
        bucket = edge_bucket(split.train, users, int(t["batch_size"]))
        if bucket not in seen:
            seen.add(bucket)
            for _ in range(int(t["warm_requests"])):  # the capture, then the graphs' first launch
                request(users)
    phases.mark("warm_requests")
    phases.report()
    return split, prog, params, pool, request


def traced_record(ctx, split, prog, params, pool, request, sample):
    from torch.profiler import record_function

    from neurec_tpu_torch.ops.topk import top_k

    t = ctx.cell.traffic
    n = int(t["traced_requests"])
    program.sync(ctx.device)
    start = time.perf_counter()
    for r in range(n):
        request(pool[r % len(pool)])
    timed = {"wall_s": time.perf_counter() - start, "units": n}

    def requests():
        for r in range(n):
            users = pool[(n + r) % len(pool)]
            with record_function("request"):
                out = request(users)
            sample.offer((users,) + out)

    w = tracing.traced(requests, ("k2",), ctx.device)
    cfg, k, B = ctx.cell.config, int(t["k"]), int(t["batch_size"])
    hyper, items = cfg["hyper"], split.num_items
    with torch.no_grad():
        u = pool[0][:B]
        scores = prog.model.predict(params, torch.from_numpy(u.astype(np.int64)).to(ctx.device))
        scores = torch.where(consumed_mask(split.train, u, ctx.device), torch.full_like(scores, -np.inf), scores)
        probe_s = tracing.event_seconds(lambda: top_k(scores, k), int(t["probe_calls"]))
    nnz, n_nodes = program.adjacency_nnz(cfg, split), split.num_users + split.num_items
    mc = counts.model(cfg["reference"])
    n_users = int(t["request_users"])
    batches = -(-n_users // B)
    record = {
        "untraced": timed,
        "traced": {"window_s": w.window_s, "busy_s": w.busy_s, "units": n, "family_s": w.family_s,
                   "family_launches": w.family_launches, "dropped": w.dropped},
        "bounds": {"k2_launch_s": counts.bound_s(counts.spmm_bytes(n_nodes, nnz, mc.spmm_width(hyper))),
                   "topk_s": counts.bound_s(counts.topk_bytes(B, items, k))},
        "topk_probe_s": probe_s,
        "flops_per_unit": batches * mc.propagate_flops(hyper, nnz, n_nodes) + mc.score_flops(hyper, n_users, items),
    }
    return record, w


def measure(ctx):
    """(the outcome but its checks, the evidence the judge reads)."""
    split, prog, params, pool, request = setup(ctx)
    t = ctx.cell.traffic
    e2e = {"setup_s": time.perf_counter() - ctx.t0}
    sample = Reservoir(int(t["checked_requests"]), ctx.seed)
    if ctx.trace:
        record, w = traced_record(ctx, split, prog, params, pool, request, sample)
        out = Outcome(e2e, record, record["untraced"]["units"], 0, 0, {}, w.busy_s, w.window_s,
                      tracing.breakdown(w))
    else:
        lat = []
        start = time.perf_counter()
        while True:
            users = pool[len(lat) % len(pool)]
            t_req = time.perf_counter()
            ids, scores = request(users)
            now = time.perf_counter()
            lat.append(now - t_req)
            sample.offer((users, ids, scores))
            if now - start >= ctx.seconds:
                break
        e2e["serve_users_per_s"] = len(lat) * int(t["request_users"]) / (now - start)
        e2e["serve_p95_ms"] = float(np.percentile(np.asarray(lat), 95)) * 1e3
        out = Outcome(e2e, None, len(lat), 0, 0, {})
    out = out._replace(memory_peak_bytes=program.memory_peak(ctx.device))
    del prog, params, request
    program.free()
    evidence = (split,) + tuple(np.concatenate([s[j] for s in sample.items]) for j in range(3))
    return out, evidence


def judge(ctx, evidence) -> dict:
    """The sampled requests' ids and scores against the reference."""
    split, users, ids, scores = evidence
    return judge_blocks(ctx, split, users, ids, scores)


def run(ctx) -> Outcome:
    out, evidence = measure(ctx)
    return out._replace(checks=judge(ctx, evidence))
