"""Sequential evaluation traffic: every user's held-out last action ranked
over the full catalogue, as ``Trainer.evaluate`` makes it
(``Evaluator.evaluate(model.predict, params)``), calls back to back.

The configuration's ``data`` is a seeded synthetic set
(``perfbench/seqdata.py``) split leave-one-out by time; the program gets it
as an in-memory dataset with its train and test time matrices. Set-up
builds the model and the evaluator, with the top-K ids of each call kept
(``record_ids``), and makes ``warm_calls`` calls: the first runs eagerly
and captures, the next replays. The window makes calls until ``--seconds``
have passed; the rate is test users ranked over the window.

Once the window has closed, the judge reads the last call and, before the
program is freed, the program's own user vectors (``eval_embeddings``) of
the judged users (``judged_users`` drawn from ``--seed``, all where 0);
then the reference encodes the same histories, built from the split itself
(``seqdata.histories``), from the same weights in float64, in blocks:

* ``topk_gap``: each judged user's ranked ids against the reference's
  scores of every item not consumed in training (``judge_topk``);
* ``encode_gap``: the largest distance between the program's user vector
  and the reference's, over the reference's norm (1: both are unit);
* ``metric_gap``: the call's HR and NDCG at each K (``Recall`` is HR with
  one test item) against those of the same ids over every test user.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts, program, seqdata, tracing
from perfbench.harness import Outcome
from perfbench.reference.common import Arith, judge_topk

BLOCK = 2048  # users a block of the reference


def load_split(ctx) -> seqdata.SeqSplit:
    spec = ctx.cell.config["data"]
    if spec.get("kind") != "synthetic_seq":
        raise ValueError("the sequential evaluation reads a synthetic_seq set, not %r" % spec.get("kind"))
    return seqdata.generate(spec)


def build(ctx, split: seqdata.SeqSplit) -> program.Program:
    from neurec_tpu_torch.data.synthetic import DictConfig, InMemoryDataset
    from neurec_tpu_torch.models import get_model

    cfg = ctx.cell.config
    train, train_t, test, test_t = split.matrices()
    dataset = InMemoryDataset(train, test, time_matrix=train_t, name=cfg["dataset"], test_time_matrix=test_t)
    conf = DictConfig(dict(cfg["hyper"], recommender=cfg["model"]))
    model = get_model(cfg["model"])(dataset, conf, device=ctx.device)
    return program.Program(split, dataset, conf, model)


def history_lengths(split: seqdata.SeqSplit, N: int) -> np.ndarray:
    """Each user's evaluated history: its train actions, at most N."""
    return np.minimum(np.diff(split.starts) - 1, N)


def test_items(split: seqdata.SeqSplit) -> np.ndarray:
    """Each user's held-out item (its last action)."""
    return split.items[split.starts[1:] - 1]


def loo_metrics(ids: np.ndarray, truth: np.ndarray, ks) -> np.ndarray:
    """(users, 2 len(ks)): HR@k for each k, then NDCG@k, of ranked lists
    ``ids`` against one held-out item a user."""
    hit = ids == truth[:, None]
    rank = np.where(hit.any(1), hit.argmax(1), ids.shape[1])
    hr = [(rank < k).astype(np.float64) for k in ks]
    ndcg = [np.where(rank < k, 1.0 / np.log2(rank + 2.0), 0.0) for k in ks]
    return np.stack(hr + ndcg, axis=1)


def consumed_mask(split: seqdata.SeqSplit, users: np.ndarray, device) -> torch.Tensor:
    """(len(users), items) True at each user's train items."""
    lo, hi = split.starts[users], split.starts[users + 1] - 1
    rows = np.repeat(np.arange(len(users)), hi - lo)
    idx = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)]) if len(users) else np.zeros(0, np.int64)
    mask = torch.zeros((len(users), split.num_items), dtype=torch.bool, device=device)
    mask[torch.from_numpy(rows).to(device), torch.from_numpy(split.items[idx]).to(device)] = True
    return mask


def judged_users(ctx, n_users: int) -> np.ndarray:
    """The users the judge covers: ``judged_users`` of them drawn from
    ``--seed`` (all where 0 or more than there are), ascending."""
    n = int(ctx.cell.traffic.get("judged_users", 0))
    if n <= 0 or n >= n_users:
        return np.arange(n_users)
    return np.sort(np.random.RandomState(ctx.seed % 2 ** 32).choice(n_users, n, replace=False))


def reference_vectors(ctx, split, users: np.ndarray, arith: Arith, fault=None):
    """The reference's user vectors of ``users`` (blocks of ``BLOCK``) and
    item vectors, from the cell's weights, in ``arith``."""
    cfg = ctx.cell.config
    ref = program.reference(cfg)
    weights = program.weights(ctx, split.num_users, split.num_items)
    N = int(cfg["hyper"]["max_sequence_length"])
    out = []
    with torch.no_grad():
        for lo in range(0, len(users), BLOCK):
            seq, lengths, ts = (torch.from_numpy(a).to(ctx.device)
                                for a in seqdata.histories(split, users[lo:lo + BLOCK], N))
            out.append(ref.user_vectors(weights, seq, lengths, ts, cfg["hyper"], arith, fault))
        return torch.cat(out), ref.item_vectors(weights, arith)


def reference_ids(ctx, split, users: np.ndarray, k: int, arith: Arith, fault=None):
    """The reference's own top-``k`` ids and user vectors of ``users`` in
    ``arith`` (with ``fault`` planted): the control's and a fault's output."""
    u, items = reference_vectors(ctx, split, users, arith, fault)
    ids = []
    with torch.no_grad():
        for lo in range(0, len(users), BLOCK):
            s = arith.mm(u[lo:lo + BLOCK], items.T)
            s = torch.where(consumed_mask(split, users[lo:lo + BLOCK], ctx.device), torch.full_like(s, -np.inf), s)
            ids.append(torch.topk(s, k, dim=1).indices.cpu().numpy())
    return np.concatenate(ids), u.float().cpu().numpy()


def judge(ctx, evidence) -> dict:
    """The last call's ids and metrics, and the program's user vectors,
    against the float64 reference."""
    split, users, ids, vectors, all_ids, metrics = evidence
    ks = [int(k) for k in ctx.cell.config["hyper"]["topk"]]
    u_ref, items = reference_vectors(ctx, split, users, Arith("float64"))
    worst = {"topk_gap": 0.0}
    with torch.no_grad():
        got = torch.from_numpy(vectors).to(ctx.device).double()
        gap = ((got - u_ref).norm(dim=1) / u_ref.norm(dim=1).clamp_min(1e-30)).max()
        worst["encode_gap"] = float(gap) if len(users) else float("inf")
        for lo in range(0, len(users), BLOCK):
            s = u_ref[lo:lo + BLOCK] @ items.T
            g = judge_topk(ids[lo:lo + BLOCK], s, consumed_mask(split, users[lo:lo + BLOCK], ctx.device))["topk_gap"]
            worst["topk_gap"] = max(worst["topk_gap"], g) if not np.isnan(g) else g
    if all_ids is None:
        worst["metric_gap"] = float("inf")
    else:
        want = loo_metrics(all_ids, test_items(split), ks).mean(0)
        worst["metric_gap"] = float(np.max(np.abs(np.asarray(metrics, np.float64) - want)))
    return worst


def setup(ctx):
    from neurec_tpu_torch.eval import Evaluator
    from neurec_tpu_torch.models import get_model

    phases = program.Phases(ctx)
    get_model(ctx.cell.config["model"])  # a program without the model fails here, before the data is made
    split = load_split(ctx)
    phases.mark("data")
    prog = build(ctx, split)
    phases.mark("model")
    if [m.lower() for m in prog.conf.get("metric")] != ["recall", "ndcg"]:
        raise ValueError("the sequential evaluation reads Recall@K and NDCG@K (HR and NDCG) alone")
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


def attention_probe(ctx, split, prog, params, users: np.ndarray, B: int) -> dict:
    """The attention kernel alone at each of the call's batches, on the
    batch's first-layer q, k and v: its time by CUDA events, and its
    bound (``counts/hstu.py``), each summed over the batches."""
    import torch.nn.functional as F

    from neurec_tpu_torch.ops import hstu

    model, hyper = prog.model, ctx.cell.config["hyper"]
    h, dqk, dv = model.num_heads, model.dqk, model.dv
    blk = params["blocks"][0]
    n_calls = int(ctx.cell.traffic["probe_calls"])
    lengths_all = history_lengths(split, model.max_len)
    probe_s = bound_s = 0.0
    with torch.no_grad():
        for lo in range(0, len(users), B):
            batch = np.zeros(B, np.int64)  # pad rows user 0, as the evaluator pads
            batch[:len(users[lo:lo + B])] = users[lo:lo + B]
            u = torch.from_numpy(batch).to(ctx.device)
            seq, lengths, ts = model._eval_seq[u], model._eval_len[u], model._eval_ts[u]
            x = model.rows_padded(params, "item_emb", seq) * (model.d ** 0.5) + params["pos_emb"][None]
            uvqk = F.silu(hstu.layer_norm(x) @ blk["w1"] + blk["b1"])
            hv, hq = h * dv, h * dqk
            v = uvqk[..., hv:2 * hv].unflatten(-1, (h, dv))
            q = uvqk[..., 2 * hv:2 * hv + hq].unflatten(-1, (h, dqk))
            k = uvqk[..., 2 * hv + hq:].unflatten(-1, (h, dqk))
            probe_s += tracing.event_seconds(
                lambda: hstu.attention_kernel(q, k, v, lengths, ts, blk["w_p"], blk["w_t"]), n_calls)
            bound_s += counts.bound_s(counts.model("hstu").attn_bytes(hyper, lengths_all[batch]),
                                      counts.model("hstu").attn_flops(hyper, lengths_all[batch]))
    return {"probe_s": probe_s, "bound_s": bound_s}


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

    w = tracing.traced(calls, ("k1",), ctx.device)
    hyper = ctx.cell.config["hyper"]
    B, items, d = int(hyper["test_batch_size"]), split.num_items, int(hyper["item_embedding_dim"])
    k = max(int(x) for x in hyper["topk"])
    users = np.asarray(evaluator.evaluator.test_users, dtype=np.int64)
    with torch.no_grad():
        u = users[:B]
        scores = prog.model.predict(params, torch.from_numpy(u).to(ctx.device))
        scores = torch.where(consumed_mask(split, u, ctx.device), torch.full_like(scores, -np.inf), scores)
        probe_s = tracing.event_seconds(lambda: top_k(scores, k), int(ctx.cell.traffic["probe_calls"]))
    mc = counts.model("hstu")
    record = {
        "untraced": timed,
        "traced": {"window_s": w.window_s, "busy_s": w.busy_s, "units": n, "family_s": w.family_s,
                   "family_launches": w.family_launches, "dropped": w.dropped},
        "bounds": {"k1_launch_s": counts.bound_s(counts.k1_bytes(B, items, d), counts.k1_flops(B, items, d)),
                   "topk_s": counts.bound_s(counts.topk_bytes(len(u), items, k))},
        "topk_probe_s": probe_s,
        "hstu_attn": attention_probe(ctx, split, prog, params, users, B),
        "flops_per_unit": mc.encode_flops(hyper, history_lengths(split, int(hyper["max_sequence_length"]))[users])
        + mc.score_flops(hyper, len(users), items),
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
    # the window's last call is judged: its ids and its metrics; the
    # program's user vectors of the judged users, from its own encoder
    test_users = np.asarray(evaluator.evaluator.test_users, dtype=np.int64)
    all_ids = evaluator.evaluator.last_ids[:n_users].cpu().numpy()
    if not np.array_equal(test_users, np.arange(split.num_users)):
        all_ids = None  # every user holds a test action: a call over fewer is wrong
    users = judged_users(ctx, split.num_users)
    metrics = [float(x) for x in result.split("\t")]
    vectors = []
    with torch.no_grad():
        for lo in range(0, len(users), BLOCK):
            u = torch.from_numpy(users[lo:lo + BLOCK]).to(ctx.device)
            vectors.append(prog.model.eval_embeddings(params, u)[0].float().cpu().numpy())
    vectors = np.concatenate(vectors) if vectors else np.zeros((0, 1), np.float32)
    ids = evaluator.evaluator.last_ids[:n_users].cpu().numpy()[users] if all_ids is not None else \
        np.full((len(users), max(int(k) for k in ctx.cell.config["hyper"]["topk"])), -1)
    out = out._replace(memory_peak_bytes=program.memory_peak(ctx.device))
    del evaluator, prog, params
    program.free()
    return out, (split, users, ids, vectors, all_ids, metrics)


def run(ctx) -> Outcome:
    out, evidence = measure(ctx)
    return out._replace(checks=judge(ctx, evidence))
