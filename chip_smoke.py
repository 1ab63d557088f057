#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neurec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

from the root of a checkout, on a machine with a CUDA device. Phases (any
failure exits non-zero before the result line):

1. device and build: prints the card's name and power limit, builds every
   kernel from ``neurec_tpu_torch/csrc`` (nvcc, ``build/neurec_tpu_torch``);
2. LightGCN serving set-up at the north-star configuration: gowalla
   (``dataset/gowalla.rating``, ratio 0.8 split cached under
   ``dataset/_tmp_gowalla``), embed_size 64, 3 layers, adj_type pre, top-20
   Recall/NDCG, eval batch 2048; random weights from a numpy seed;
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with time, roofline bound, plain-version
   time and a library call's time: K1 in both mask modes, K2 over the plan
   of A (forward) and over the plan of A^T (``plan_spmm[bwd]``, the
   backward of the propagation);
4. the serving path, with every launch count set to 0 just before and
   read just after: full evaluation of every test user (twice: cold, then
   warm) and 4 ``batch_topk`` requests of 512 users (k=20, consumed items
   masked), plus a k-clamp request;
5. the same path through the plain versions: metrics within 1e-5 and
   top-20 ids agreeing in >= 99.9% of positions, near-ties the only
   difference;
6. the training path, counted the same way: ``run.main`` trains the
   north star (batch 2048, lr 0.001, reg 1e-4, Adam) for 2 epochs with an
   evaluation after each. It fails on a non-finite loss, an epoch-2 loss
   not below epoch 1's, a trained Recall@20 not above phase 4's random
   weights, or K2 launch counts other than 3 forward + 3 backward per step
   and 3 forward per evaluation;
7. where a training step's time goes: CUDA-event times of the step, its
   forward, Adam and one step's negative draw (``--profile`` adds a
   ``torch.profiler`` table of device time per kernel);
8. 5 training steps from the trained state through the kernels and again
   through the plain versions, on the same draws: params within
   ``TRAIN_PARAM_ATOL``, step losses within ``TRAIN_LOSS_RTOL``.

Float32 matrix products run in full f32 (TF32 off) everywhere, as in the
JAX package on the CPU.

The last lines: ``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores

SEED = 2024
EVAL_USERS_PER_BATCH = 2048
SERVING_REQUESTS, SERVING_USERS, SERVING_K = 4, 512, 20
# both sides compute in f32 with another summation order (d = 64 terms)
ATOL = RTOL = 1e-5

NORTHSTAR_ARGS = [
    "--recommender=LightGCN",
    "--config_dir=%s" % os.path.join(REPO, "conf"),
    "--data.input.path=%s" % os.path.join(REPO, "dataset"),
    "--data.cache.path=%s" % os.path.join(REPO, "dataset"),
    "--data.input.dataset=gowalla",
    "--data.column.format=UI",
    "--data.convert.separator=','",
    "--splitter=ratio",
    "--ratio=0.8",
    "--by_time=False",
    "--embed_size=64",
    "--n_layers=3",
    "--adj_type=pre",
    "--topk=[20]",
    "--metric=[\"Recall\",\"NDCG\"]",
    "--test_batch_size=%d" % EVAL_USERS_PER_BATCH,
]
# the north star's training hyperparameters (benchmarks/gowalla_northstar.py:34-37)
TRAIN_EPOCHS = 2
TRAIN_ARGS = NORTHSTAR_ARGS + [
    "--epochs=%d" % TRAIN_EPOCHS, "--verbose=1", "--learner=adam",
    "--batch_size=2048", "--lr=0.001", "--reg=1e-4",
]
PLAIN_STEPS = 5
# Kernel and plain SpMM sum in other orders, so the gradients differ by f32
# noise (~1e-7 relative). Adam passes it on as lr * d(g / (sqrt(v) + 1e-8)):
# ~1e-7 of a step where |g| >> 1e-8, at most ~1e-4 of a step (lr = 1e-3)
# where g is itself cancellation noise near 1e-8. Over 5 steps that stays
# below 1e-6; 1e-5 leaves room, and is still 1% of one Adam step.
TRAIN_PARAM_ATOL = 1e-5
TRAIN_LOSS_RTOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, got, want):
    """(max_abs_err, ok): -inf at the same places, finite values within
    ATOL + RTOL * |want|."""
    inf_got, inf_want = torch.isinf(got), torch.isinf(want)
    same_inf = bool(torch.equal(inf_got, inf_want))
    finite = ~inf_want
    diff = torch.where(finite, (got - want).abs(), torch.zeros_like(got))
    err = float(diff.max()) if diff.numel() else 0.0
    ok = same_inf and bool(torch.isfinite(got[finite]).all()) and bool(
        (diff <= ATOL + RTOL * torch.where(finite, want.abs(), torch.zeros_like(want))).all()
    )
    return err, ok


def glorot_numpy(rng, shape):
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return rng.uniform(-limit, limit, size=shape).astype("float32")


def parse_metrics(line: str):
    return [float(x) for x in line.split("\t")]


def sparse_csr(torch, np, matrix):
    return torch.sparse_csr_tensor(
        torch.from_numpy(matrix.indptr.astype(np.int64)), torch.from_numpy(matrix.indices.astype(np.int64)),
        torch.from_numpy(matrix.data), size=matrix.shape, check_invariants=True,
    ).cuda()


def profile_steps(torch, step, n=10):
    """``torch.profiler`` over ``n`` calls of ``step``: device time per
    kernel (their sum is the device's busy time; one stream, so kernels do
    not overlap) and host time per operator, per step, the largest first.
    None where the profiler shows no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # a user range on the device (Optimizer.step) spans kernels counted on their own
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.self_device_time_total, e.key, e.count))
        elif e.self_cpu_time_total > 0:
            ops.append((e.self_cpu_time_total, e.key, e.count))
    if not kernels:
        return None

    def top(rows):
        return [{"name": key[:90], "ms_per_step": us / n / 1e3, "calls_per_step": count / n}
                for us, key, count in sorted(rows, reverse=True)[:12]]

    return {"steps": n, "wall_ms_per_step_profiled": wall_ms / n,
            "device_ms_per_step": sum(k[0] for k in kernels) / n / 1e3,
            "kernel_launches_per_step": sum(k[2] for k in kernels) / n,
            "kernels": top(kernels), "host_ops": top(ops)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "neurec_tpu_torch", "csrc")):
        print("chip_smoke: neurec_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)  # the run logger writes under ./log
    profile = "--profile" in sys.argv[1:]

    import copy

    import numpy as np
    import scipy.sparse as sp

    from neurec_tpu_torch import run
    from neurec_tpu_torch.bridge import params_from_numpy
    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.data.dataset import Dataset
    from neurec_tpu_torch.eval import Evaluator
    from neurec_tpu_torch.eval.tiers import global_bits_width
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.ops import masked_scores as k1
    from neurec_tpu_torch.ops import spmm as k2
    from neurec_tpu_torch.ops.sampling import sample_negatives
    from neurec_tpu_torch.ops.topk import top_k
    from neurec_tpu_torch.recommend import batch_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- 1. device and build ------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {
        name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        for name, text in reports.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # -- 2. set-up ----------------------------------------------------------
    t0 = time.perf_counter()
    conf = Config(os.path.join(REPO, "NeuRec.properties"), cmd_args=NORTHSTAR_ARGS)
    dataset = Dataset(conf)
    model = get_model("LightGCN")(dataset, conf)  # device=None: cuda
    rng = np.random.RandomState(SEED)
    params = params_from_numpy({
        "user_emb": glorot_numpy(rng, (dataset.num_users, model.emb_dim)),
        "item_emb": glorot_numpy(rng, (dataset.num_items, model.emb_dim)),
    })
    evaluator = Evaluator.from_dataset(dataset, conf)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "num_users": dataset.num_users, "num_items": dataset.num_items,
          "train_nnz": int(dataset.train_matrix.nnz),
          "eval_users": len(evaluator.evaluator.test_users)})

    # -- 3. kernels against their plain versions -----------------------------
    I, d = dataset.num_items, model.emb_dim
    width = global_bits_width(I)
    plan = model.adj.plan
    ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0).contiguous()
    with torch.no_grad():
        u_table, item_table = model.propagate(params)
    users = torch.from_numpy(evaluator.evaluator.test_users[:EVAL_USERS_PER_BATCH]).long().cuda()
    u = u_table[users].contiguous()
    train_rows = torch.from_numpy(
        evaluator.evaluator._host_rows(users.cpu().numpy())
    ).cuda()
    bits = k1.pack_train_bits(train_rows, I, block_items=width)
    mask8 = k1.build_train_mask(train_rows, I)
    B = u.shape[0]

    kernels = []

    def check(name, source, replaces, run, plain, library, n_bytes, n_flops, extra=None):
        got, want = run(), plain()
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want)
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL),
            "ms": time_ms(torch, run), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library) if library is not None else None,
        }
        rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_flops)
        rec.update(extra or {})
        emit({"phase": "kernel", **rec})
        require(ok, "%s disagrees with its plain version: max_abs_err %g" % (name, err))
        return rec

    out_bytes = B * I * 4
    factor_bytes = u.numel() * 4 + I * d * 4
    k1_flops = 2.0 * B * I * d
    k1_rec = check(
        "masked_scores", "neurec_tpu_torch/csrc/masked_scores.cu",
        "neurec_tpu/ops/pallas_kernels.py:37",
        lambda: k1.masked_scores_bits(u, item_table, bits, width, I),
        lambda: k1.masked_scores_bits_reference(u, item_table, bits, width, I),
        lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u, item_table.T)),
        factor_bytes + bits.numel() + out_bytes, k1_flops,
        {"mode": "bits", "shape": [B, I, d]},
    )
    int8_rec = check(
        "masked_scores[int8]", "neurec_tpu_torch/csrc/masked_scores.cu",
        "neurec_tpu/ops/pallas_kernels.py:37",
        lambda: k1.masked_scores(u, item_table, train_rows),
        lambda: k1.masked_scores_reference(u, item_table, train_rows),
        None,
        factor_bytes + train_rows.numel() * 4 + out_bytes, k1_flops,
        {"mode": "int8", "shape": [B, I, d]},
    )
    rows_np, cols_np, vals_np = (t.cpu().numpy() for t in (model.adj.rows, model.adj.cols, model.adj.vals))
    csr_sp = sp.csr_matrix((vals_np, (rows_np, cols_np)), shape=(model.adj.n_nodes,) * 2)
    csr = sparse_csr(torch, np, csr_sp)
    nnz = int((plan.vals != 0).sum())
    plan_bytes = sum(t.numel() * 4 for t in (plan.rows, plan.cols, plan.vals, plan.tile_ptr))
    k2_rec = check(
        "plan_spmm", "neurec_tpu_torch/csrc/plan_spmm.cu",
        "neurec_tpu/ops/pallas_spmm.py:144",
        lambda: k2.plan_spmm(plan, ego),
        lambda: k2.plan_spmm_reference(plan, ego),
        lambda: torch.sparse.mm(csr, ego),
        plan_bytes + ego.numel() * 4 + plan.n_rows * d * 4, 2.0 * nnz * d,
        {"shape": [plan.n_rows, int(plan.rows.shape[0]), d], "nnz": nnz},
    )
    # the backward of the propagation: K2 over the plan of A^T, on a
    # gradient-sized input made from the numpy seed
    plan_t = model.adj.plan_t
    g = torch.from_numpy(
        np.random.RandomState(SEED + 1).standard_normal((model.adj.n_nodes, d)).astype(np.float32)
    ).cuda()
    csr_t = sparse_csr(torch, np, csr_sp.T.tocsr())
    nnz_t = int((plan_t.vals != 0).sum())
    plan_t_bytes = sum(t.numel() * 4 for t in (plan_t.rows, plan_t.cols, plan_t.vals, plan_t.tile_ptr))
    k2t_rec = check(
        "plan_spmm[bwd]", "neurec_tpu_torch/csrc/plan_spmm.cu",
        "neurec_tpu/ops/pallas_spmm.py:504",
        lambda: k2.plan_spmm(plan_t, g),
        lambda: k2.plan_spmm_reference(plan_t, g),
        lambda: torch.sparse.mm(csr_t, g),
        plan_t_bytes + g.numel() * 4 + plan_t.n_rows * d * 4, 2.0 * nnz_t * d,
        {"shape": [plan_t.n_rows, int(plan_t.rows.shape[0]), d], "nnz": nnz_t},
    )
    # where an eval batch and a serving request spend their time besides
    # the kernels: the lowest-id-first top-K (a stable sort of each row)
    masked = k1.masked_scores_bits(u, item_table, bits, width, I)
    emit({"phase": "breakdown",
          "eval_batch_topk_ms": time_ms(torch, lambda: top_k(masked, SERVING_K)),
          "serving_batch_topk_ms": time_ms(torch, lambda: top_k(masked[:SERVING_USERS], SERVING_K)),
          "serving_batch_scores_ms": time_ms(torch, lambda: u[:SERVING_USERS] @ item_table.T)})
    again = k2.plan_spmm(plan, ego)
    require(torch.equal(again, k2.plan_spmm(plan, ego)), "plan_spmm is not deterministic")
    again = k2.plan_spmm(plan_t, g)
    require(torch.equal(again, k2.plan_spmm(plan_t, g)), "plan_spmm over plan_t is not deterministic")

    # -- 4. the main path, counted ------------------------------------------
    users_all = rng.choice(dataset.num_users, SERVING_REQUESTS * SERVING_USERS, replace=False)
    requests = users_all.reshape(SERVING_REQUESTS, SERVING_USERS)

    def serve():
        out, secs = [], []
        for req in requests:
            t = time.perf_counter()
            items, scores = batch_topk(
                model, params, SERVING_K, users=req, train_matrix=dataset.train_matrix,
                batch_size=SERVING_USERS,
            )
            secs.append(time.perf_counter() - t)
            out.append((items, scores))
        return out, secs

    _build.reset_launches()
    t = time.perf_counter()
    eval_cold = evaluator.evaluate(model.predict, params)
    torch.cuda.synchronize()
    eval_cold_s = time.perf_counter() - t
    t = time.perf_counter()
    eval_warm = evaluator.evaluate(model.predict, params)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t
    served, serve_s = serve()
    clamp_items, clamp_scores = batch_topk(model, params, I + 5, users=requests[0][:2])
    launches = dict(_build.LAUNCHES)

    n_eval = len(evaluator.evaluator.test_users)
    emit({"phase": "main_path", "metrics": evaluator.metrics_info(), "result": eval_warm,
          "eval_users": n_eval, "eval_cold_s": eval_cold_s, "eval_warm_s": eval_warm_s,
          "eval_users_per_s": n_eval / eval_warm_s,
          "serving_request_s": serve_s,
          "serving_users_per_s": SERVING_REQUESTS * SERVING_USERS / sum(serve_s),
          "launches": launches})
    for name in _build.SOURCES:
        require(launches[name] > 0, "kernel %s was not launched on the main path" % name)
    require(eval_cold == eval_warm, "two evaluations of the same params differ")
    metrics = parse_metrics(eval_warm)
    require(all(np.isfinite(metrics)) and all(0.0 <= m <= 1.0 for m in metrics),
            "metrics out of range: %s" % eval_warm)
    train = dataset.train_matrix.tocsr()
    for req, (items, scores) in zip(requests, served):
        require(items.shape == (SERVING_USERS, SERVING_K) and items.dtype == np.int32,
                "batch_topk returned %s %s" % (items.shape, items.dtype))
        require(np.isfinite(scores).all(), "non-finite serving scores")
        require((np.diff(scores, axis=1) <= 0).all(), "serving scores not non-increasing")
        for uid, row in zip(req, items):
            consumed = train.indices[train.indptr[uid]:train.indptr[uid + 1]]
            require(not np.intersect1d(row, consumed).size, "consumed item served to user %d" % uid)
    require(clamp_items.shape == (2, I), "k clamp: got %s" % (clamp_items.shape,))

    # -- 5. the same path through the plain versions ------------------------
    with mock.patch.object(k2, "plan_spmm", k2.plan_spmm_reference), \
            mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference), \
            mock.patch.object(k1, "masked_scores", k1.masked_scores_reference):
        eval_plain = evaluator.evaluate(model.predict, params)
        served_plain, _ = serve()
    metric_err = max(abs(a - b) for a, b in zip(metrics, parse_metrics(eval_plain)))
    ids_k = np.stack([s[0] for s in served])
    ids_p = np.stack([s[0] for s in served_plain])
    sc_k = np.stack([s[1] for s in served])
    sc_p = np.stack([s[1] for s in served_plain])
    differ = ids_k != ids_p
    agree = 1.0 - differ.mean()
    near_tie = np.abs(sc_k - sc_p)[differ].max(initial=0.0)
    emit({"phase": "plain_path", "result": eval_plain, "metric_max_abs_diff": metric_err,
          "top20_id_agreement": agree, "differing_positions": int(differ.sum()),
          "max_score_gap_where_ids_differ": float(near_tie)})
    require(metric_err <= 1e-5, "metrics differ from the plain path by %g" % metric_err)
    require(agree >= 0.999, "top-20 ids agree in only %.5f of positions" % agree)
    require(near_tie <= ATOL + RTOL * np.abs(sc_p).max(), "ids differ beyond a near-tie")

    # -- 6. the training path, counted --------------------------------------
    _build.reset_launches()
    t = time.perf_counter()
    trainer, train_result = run.main(os.path.join(REPO, "NeuRec.properties"), cmd_args=TRAIN_ARGS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches = dict(_build.LAUNCHES)

    tmodel = trainer.model
    with open(trainer.logger.path + ".metrics.jsonl") as fin:
        records = [json.loads(line) for line in fin]
    losses = [r["loss"] for r in records]
    epoch_s = [r["time_s"] for r in records]
    n_evals = sum("metrics" in r for r in records)
    steps, B = trainer.steps, tmodel.batch_size
    trained = parse_metrics(train_result)
    emit({"phase": "train", "epochs": len(records), "steps_per_epoch": steps, "batch_size": B,
          "train_interactions": trainer.n_positives, "pad_slots": steps * B - trainer.n_instances,
          "epoch_loss": losses, "epoch_s": epoch_s,
          "train_examples_per_s": [trainer.n_positives / s for s in epoch_s],
          "epoch_ms_per_step": [1e3 * s / steps for s in epoch_s],
          "metrics": evaluator.metrics_info(),
          "result_after_epoch": [r["metrics"]["values"] for r in records if "metrics" in r],
          "random_init_result": eval_warm, "run_main_s": train_s, "launches": train_launches})
    require(len(records) == TRAIN_EPOCHS, "run.main trained %d epochs" % len(records))
    require(all(np.isfinite(losses)), "non-finite epoch loss: %s" % losses)
    require(losses[-1] < losses[0], "the epoch-%d loss %g is not below epoch 1's %g"
            % (len(losses), losses[-1], losses[0]))
    require(trained[0] > metrics[0], "Recall@20 after training %g is not above random weights' %g"
            % (trained[0], metrics[0]))
    n_fwd = tmodel.n_layers * (steps * TRAIN_EPOCHS + n_evals)
    n_bwd = tmodel.n_layers * steps * TRAIN_EPOCHS
    require(train_launches["plan_spmm"] > 0 and train_launches["plan_spmm_t"] > 0,
            "K2 was not launched on the training path: %s" % train_launches)
    require((train_launches["plan_spmm"], train_launches["plan_spmm_t"]) == (n_fwd, n_bwd),
            "K2 launches %s, expected %d forward and %d backward"
            % (train_launches, n_fwd, n_bwd))

    # -- 7. where a training step's time goes --------------------------------
    def clone_state():
        params_c = {k: v.detach().clone().requires_grad_(True) for k, v in trainer.params.items()}
        opt_c = trainer.tx(params_c.values())
        opt_c.load_state_dict(copy.deepcopy(trainer.opt_state.state_dict()))
        return params_c, opt_c

    draw_ms = time_ms(torch, lambda: trainer.draw_epoch(trainer.epoch_generator(3)), iters=3, warmup=1)
    inst, w, negs = trainer.draw_epoch(trainer.epoch_generator(3))
    params_b, opt_b = clone_state()
    batch, w0 = trainer._batch(inst[0], negs[0]), w[0]
    rows0 = trainer._padded_items[batch["users"]]
    gen = trainer.epoch_generator(4)

    def step():
        opt_b.zero_grad(set_to_none=True)
        tmodel.loss(params_b, batch, w0).backward()
        opt_b.step()

    step_ms = time_ms(torch, step)
    forward_ms = time_ms(torch, lambda: tmodel.loss(params_b, batch, w0))
    adam_ms = time_ms(torch, opt_b.step)
    epoch_steps_ms = time_ms(torch, lambda: trainer.run_epoch(params_b, opt_b, inst, w, negs), iters=2, warmup=1)
    k2_fwd_ms, k2_bwd_ms = tmodel.n_layers * k2_rec["ms"], tmodel.n_layers * k2t_rec["ms"]
    prof = profile_steps(torch, step) if profile else None
    if prof is not None:
        # the profiler slows the host, not the kernels: the device's share
        # of an unprofiled step
        prof["device_busy_share_of_step"] = prof["device_ms_per_step"] / step_ms
    emit({"phase": "train_breakdown", "step_ms": step_ms,
          "run_epoch_ms_per_step": epoch_steps_ms / steps,
          "draw_epoch_ms_per_step": draw_ms / steps,
          "sampler_ms_per_step": time_ms(torch, lambda: sample_negatives(gen, rows0, I, ())),
          "forward_ms": forward_ms, "backward_ms": step_ms - forward_ms - adam_ms, "adam_ms": adam_ms,
          "k2_forward_ms": k2_fwd_ms, "k2_backward_ms": k2_bwd_ms,
          "rest_ms": step_ms - k2_fwd_ms - k2_bwd_ms - adam_ms,
          "profile": prof if profile else "not run (--profile)"})

    # -- 8. training steps through the plain versions ------------------------
    def some_steps():
        params_c, opt_c = clone_state()
        step_losses = []
        for s in range(PLAIN_STEPS):
            sl = slice(s, s + 1)
            step_losses.append(float(trainer.run_epoch(params_c, opt_c, inst[sl], w[sl], negs[sl])[2]))
        return params_c, step_losses

    params_k, losses_k = some_steps()
    with mock.patch.object(k2, "plan_spmm", k2.plan_spmm_reference):
        params_p, losses_p = some_steps()
    with torch.no_grad():
        param_err = max(float((params_k[n] - params_p[n]).abs().max()) for n in params_k)
        moved = max(float((params_k[n] - trainer.params[n]).abs().max()) for n in params_k)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    emit({"phase": "train_plain_path", "steps": PLAIN_STEPS, "losses": losses_k, "plain_losses": losses_p,
          "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err, "param_max_abs_move": moved,
          "tol": "params atol %g, losses rtol %g" % (TRAIN_PARAM_ATOL, TRAIN_LOSS_RTOL)})
    require(all(np.isfinite(losses_k)) and moved > 0, "the kernel steps did not train")
    require(param_err <= TRAIN_PARAM_ATOL, "params differ from the plain path by %g" % param_err)
    require(loss_rel <= TRAIN_LOSS_RTOL, "step losses differ from the plain path by %g" % loss_rel)

    for rec, name in ((k1_rec, "masked_scores"), (int8_rec, "masked_scores"), (k2_rec, "plan_spmm"),
                      (k2t_rec, "plan_spmm_t")):
        rec["launches_by_path"] = {"serve": launches[name], "train": train_launches[name]}
        rec["launches"] = launches[name] + train_launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    emit({"kernels": [{k: rec[k] for k in keys} for rec in (k1_rec, k2_rec, k2t_rec)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
