"""Training traffic: whole epochs of ``Trainer.train_epoch``, back to back.

Set-up builds the one Trainer the window uses, gives it the benchmark's
weights and a fresh optimizer, and drives it from the seed through its
first ``checked_steps`` steps: the first steps of epoch 1's draws, rows
that all differ, one ``run_epoch`` call a step (the call ``train_epoch``
makes after its draw), so that each step's loss and the optimizer's state
after one step can be read. Whole epochs from epoch 2 are the warm-up:
they run until an epoch captures no graph (``Trainer.kept``). The window
then runs whole epochs until ``--seconds`` have passed; the rate is every
training triple of those epochs over their whole time.

Once the window has closed and the peak is read, one more epoch runs by
``train_epoch``, the window's call, through the window's kept program,
from the trainer's state then (its params and Adam state, kept aside
before the call); its draws are drawn again from its generator
(``draw_epoch`` of ``epoch_generator(e)``, a function of the epoch). The
program is freed. The reference judges the draws of the checked steps and
of that epoch (each real row a distinct instance, weights 0 or 1, each
negative an item of range the user never trained on) and takes the same
steps on them in float32. The checked steps start from its own weights
drawn from the seed and a fresh Adam: each step's loss, the first gradient
as the program's Adam state holds it after one step (its first moment
over 1 - b1) and each leaf's change after the steps, by the worst leaf.
The epoch starts from the kept-aside state, which only the program's run
reaches: the epoch's mean loss, each leaf's Adam first moment after it
(the running mean of its gradients) and each leaf's change over it.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from perfbench import counts, data, program, tracing
from perfbench.harness import Outcome
from perfbench.reference.common import Adam, Arith, leaf_gaps, leaves, map_tree, unflatten

B1 = 0.9  # optax.adam's first-moment decay: mu after one step is (1 - B1) g


def _host(draws, rows=slice(None)) -> dict:
    return {"inst": draws.inst[rows].cpu().numpy(), "w": draws.w[rows].cpu().numpy(),
            "negs": draws.negs[rows].cpu().numpy(), "seeds": [int(v) for v in draws.seeds[rows]]}


def setup(ctx):
    """(split, trainer, checked, phases): the program's trainer after the
    checked steps, what they produced, for the judge, and the set-up's
    phases so far."""
    from neurec_tpu_torch.trainer import Trainer

    phases = program.Phases(ctx)
    split = program.load_split(ctx)
    phases.mark("split")
    prog = program.build(ctx, split)
    phases.mark("model")
    trainer = Trainer(prog.model, prog.dataset, prog.conf, logger=program.SilentLogger(), seed=ctx.seed,
                      device=ctx.device)
    phases.mark("trainer")
    trainer.params = map_tree(lambda t: t.detach().requires_grad_(True),
                              program.weights(ctx, split.num_users, split.num_items))
    trainer.opt_state = trainer.init_opt_state(trainer.params)
    phases.mark("weights")
    n = int(ctx.cell.traffic["checked_steps"])
    draws = trainer.draw_epoch(trainer.epoch_generator(1))
    losses, grad1 = [], {}
    for s in range(n):
        out = trainer.run_epoch(trainer.params, trainer.opt_state, *(a[s:s + 1] for a in draws), epoch=1)
        losses.append(float(out[2]))
        if s == 0:
            state = trainer.opt_state.state
            grad1 = {path: float(state[p]["exp_avg"].double().norm()) / (1 - B1) if p in state else 0.0
                     for path, p in leaves(trainer.params)}
    start = dict(leaves(program.weights(ctx, split.num_users, split.num_items)))
    change = {path: float((p.detach() - start[path]).double().norm()) for path, p in leaves(trainer.params)}
    del start
    phases.mark("checked_steps")
    checked = dict(_host(draws, slice(0, n)), losses=losses, grad1=grad1, change=change)
    return split, trainer, checked, phases


def moments(trainer) -> dict:
    """The norm of each leaf's Adam first moment (0 before its first step)."""
    state = trainer.opt_state.state
    return {path: float(state[p]["exp_avg"].double().norm()) if p in state else 0.0
            for path, p in leaves(trainer.params)}


def kept_aside(trainer) -> dict:
    """The trainer's state, on the device: each leaf, its Adam moments,
    and the step count."""
    state = trainer.opt_state.state
    out = {"params": {}, "mu": {}, "nu": {}, "t": 0}
    for path, p in leaves(trainer.params):
        out["params"][path] = p.detach().clone()
        if p in state:
            out["mu"][path] = state[p]["exp_avg"].detach().clone()
            out["nu"][path] = state[p]["exp_avg_sq"].detach().clone()
            out["t"] = int(state[p]["step"])
    return out


def checked_epoch(trainer, epoch: int) -> dict:
    """Epoch ``epoch`` by ``trainer.train_epoch``, with what the judge reads
    of it: the state it started from, its draws, its mean loss, each
    leaf's first moment after it and change over it."""
    start = kept_aside(trainer)
    loss = float(trainer.train_epoch(epoch)[2])
    change = {path: float((p.detach() - start["params"][path]).double().norm()) for path, p in leaves(trainer.params)}
    draws = trainer.draw_epoch(trainer.epoch_generator(epoch))
    return dict(_host(draws), start=start, loss=loss, change=change, moment=moments(trainer))


def warm_up(ctx, trainer, epoch: int) -> int:
    """Whole epochs until one captures nothing; returns the next epoch."""
    for _ in range(int(ctx.cell.traffic["warmup_epochs_max"])):
        float(trainer.train_epoch(epoch)[2])
        epoch += 1
        kept = trainer.kept.get("epoch")
        if kept is None or kept.captured == 0:
            return epoch
    raise RuntimeError("epochs still capture after %s warm-up epochs" % ctx.cell.traffic["warmup_epochs_max"])


def window(ctx, trainer, epoch: int):
    """Whole epochs back to back for ``ctx.seconds``: (epochs, seconds,
    epochs whose loss was not finite)."""
    done = bad = 0
    start = time.perf_counter()
    while True:
        loss = float(trainer.train_epoch(epoch)[2])
        epoch += 1
        done += 1
        bad += not np.isfinite(loss)
        elapsed = time.perf_counter() - start
        if elapsed >= ctx.seconds:
            return done, elapsed, bad


def traced_record(ctx, split, trainer, epoch: int):
    """The trace run's record: ``traced_epochs`` epochs timed by the host,
    as ``train_epoch`` runs them but with the draw timed apart (each part
    ended by a synchronize), then as many under the profiler, in spans
    ``draw`` and ``run``."""
    from torch.profiler import record_function

    n = int(ctx.cell.traffic["traced_epochs"])
    timed = {"draw_s": 0.0}

    def one(e, timed=None):
        with record_function("draw"):
            t = time.perf_counter()
            draws = trainer.draw_epoch(trainer.epoch_generator(e))
            program.sync(ctx.device)
            if timed is not None:
                timed["draw_s"] += time.perf_counter() - t
        with record_function("run"):
            float(trainer.run_epoch(trainer.params, trainer.opt_state, *draws, epoch=e)[2])

    program.sync(ctx.device)
    start = time.perf_counter()
    for e in range(epoch, epoch + n):
        one(e, timed)
    timed.update(wall_s=time.perf_counter() - start, units=n * trainer.steps)
    w = tracing.traced(lambda: [one(e) for e in range(epoch + n, epoch + 2 * n)], ("k2",), ctx.device)
    cfg = ctx.cell.config
    hyper = cfg["hyper"]
    nnz, n_nodes = program.adjacency_nnz(cfg, split), split.num_users + split.num_items
    mc = counts.model(cfg["reference"])
    record = {
        "untraced": timed,
        "traced": {"window_s": w.window_s, "busy_s": w.busy_s, "units": n * trainer.steps,
                   "family_s": w.family_s, "family_launches": w.family_launches,
                   "run_device_s": tracing.span_device_s(w, "run"), "dropped": w.dropped},
        "bounds": {"k2_launch_s": counts.bound_s(counts.spmm_bytes(n_nodes, nnz, mc.spmm_width(hyper)))},
        "flops_per_unit": mc.train_step_flops(hyper, nnz, n_nodes, int(hyper["batch_size"])),
    }
    return record, w


def judge_draws(split, checked) -> int:
    """Faults in checked draws: a real row that is out of range or repeats
    another, a weight other than 0 or 1, a negative out of range or among
    the slot's user's train items."""
    users_np, items_np = data.flat_train(split.train)
    inst, w, negs = checked["inst"].astype(np.int64), checked["w"], checked["negs"].astype(np.int64)
    n_inst, n_items = len(users_np), split.num_items
    ids = inst[w > 0]
    faults = int(np.sum((ids < 0) | (ids >= n_inst))) + int(len(ids) - len(np.unique(ids)))
    faults += int(np.sum((w != 0) & (w != 1))) + int(np.sum((inst < 0) | (inst >= n_inst)))
    out_of_range = (negs < 0) | (negs >= n_items)
    consumed = np.isin(users_np[np.clip(inst, 0, n_inst - 1)] * n_items + np.clip(negs, 0, n_items - 1),
                       users_np * n_items + items_np)
    return faults + int(np.sum(out_of_range)) + int(np.sum(consumed & ~out_of_range))


def reference_steps(ctx, split, checked, arith: Arith = Arith("float32"), fault=None) -> dict:
    """Checked steps taken by the reference in ``arith`` on the same draws:
    from its own weights and a fresh Adam where ``checked`` has no
    ``start`` (the first steps), else from that state (the epoch after the
    window). Each step's loss, the first step's gradient norms by leaf,
    each leaf's first moment after the steps and change over them.
    ``fault(batch)``, where given, alters the batches (a fault planted in
    the reference put in the program's place)."""
    cfg, dev = ctx.cell.config, ctx.device
    hyper = cfg["hyper"]
    ref = program.reference(cfg)
    g = ref.graph(split.train, hyper, dev)
    users_np, items_np = data.flat_train(split.train)
    inst = np.clip(checked["inst"].astype(np.int64), 0, len(users_np) - 1)
    adam = Adam(float(hyper.get("lr", hyper.get("learning_rate"))))
    start = checked.get("start")
    if start is None:
        params = map_tree(lambda t: t.detach().clone().to(arith.dtype).requires_grad_(True),
                          program.weights(ctx, split.num_users, split.num_items))
    else:
        params = map_tree(lambda t: t.clone().to(arith.dtype).requires_grad_(True), unflatten(start["params"]))
        adam.t = start["t"]
        adam.mu = {p: v.clone().to(arith.dtype) for p, v in start["mu"].items()}
        adam.nu = {p: v.clone().to(arith.dtype) for p, v in start["nu"].items()}
    flat = dict(leaves(params))
    before = {p: t.detach().clone() for p, t in flat.items()}
    users_t, items_t = torch.from_numpy(users_np).to(dev), torch.from_numpy(items_np).to(dev)
    losses, grad1 = [], {}
    for s in range(len(inst)):
        rows = torch.from_numpy(inst[s]).to(dev)
        batch = {"users": users_t[rows], "pos": items_t[rows],
                 "neg": torch.from_numpy(checked["negs"][s].astype(np.int64)).to(dev),
                 "w": torch.from_numpy(checked["w"][s]).to(dev)}
        if fault is not None:
            batch = fault(batch)
        masks = ref.step_masks(hyper, checked["seeds"][s], g.n_nodes, dev)
        loss = ref.loss(params, g, hyper, batch, arith, masks)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()), allow_unused=True)))
        if s == 0:
            grad1 = {p: float(v.double().norm()) if v is not None else 0.0 for p, v in grads.items()}
        losses.append(float(loss.detach()))
        adam.step(flat, grads)
    return {
        "losses": losses, "loss": sum(losses) / len(losses), "grad1": grad1,
        "change": {p: float((flat[p].detach() - before[p]).double().norm()) for p in flat},
        "moment": {p: float(adam.mu[p].double().norm()) if p in adam.mu else 0.0 for p in flat},
    }


def compare(got: dict, ref: dict) -> dict:
    """The numbers of ``got`` (the program's checked steps) against ``ref``
    (the reference's): the worst step's loss gap; the worst leaf's gap of
    the first gradient's norm and of the change's; and the median leaf's
    gap of the change, steady where a few elements' updates, their
    gradients at rounding level, swing the worst leaf's."""
    change = leaf_gaps(got["change"], ref["change"], ref["grad1"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": max(leaf_gaps(got["grad1"], ref["grad1"], ref["grad1"]).values()),
        "delta_gap": max(change.values()),
        "delta_gap_median": statistics.median(change.values()),
    }


def compare_epoch(got: dict, ref: dict) -> dict:
    """The numbers of ``got`` (the program's epoch after the window)
    against ``ref``: the mean loss's gap; the worst leaf's gap of the first
    moment's norm after the epoch and of the change's over it; the median
    leaf's gap of the change. Leaves are left out by the reference's first
    moment, the running mean of their gradients (``leaf_gaps``)."""
    change = leaf_gaps(got["change"], ref["change"], ref["moment"])
    return {
        "epoch_loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        "epoch_moment_gap": max(leaf_gaps(got["moment"], ref["moment"], ref["moment"]).values()),
        "epoch_delta_gap": max(change.values()),
        "epoch_delta_gap_median": statistics.median(change.values()),
    }


def judge(ctx, evidence) -> dict:
    split, checked, epoch = evidence
    out = dict(compare(checked, reference_steps(ctx, split, checked)),
               **compare_epoch(epoch, reference_steps(ctx, split, epoch)))
    out["draw_faults"] = float(judge_draws(split, checked) + judge_draws(split, epoch))
    return out


def measure(ctx):
    """(the outcome but its checks, the evidence the judge reads)."""
    split, trainer, checked, phases = setup(ctx)
    epoch = warm_up(ctx, trainer, 2)
    phases.mark("warm_up")
    phases.report()
    setup_s = time.perf_counter() - ctx.t0
    e2e = {"setup_s": setup_s}
    if ctx.trace:
        record, w = traced_record(ctx, split, trainer, epoch)
        epoch += 2 * int(ctx.cell.traffic["traced_epochs"])
        out = Outcome(e2e, record, record["untraced"]["units"], 0, 0, {}, w.busy_s, w.window_s, tracing.breakdown(w))
    else:
        epochs, elapsed, bad = window(ctx, trainer, epoch)
        epoch += epochs
        e2e["train_examples_per_s"] = epochs * trainer.n_instances / elapsed
        out = Outcome(e2e, None, epochs * trainer.steps, bad, 0, {})
    out = out._replace(memory_peak_bytes=program.memory_peak(ctx.device))
    after = checked_epoch(trainer, epoch)
    trainer.release_kept()
    del trainer
    program.free()
    return out, (split, checked, after)


def run(ctx) -> Outcome:
    out, evidence = measure(ctx)
    return out._replace(checks=judge(ctx, evidence))
