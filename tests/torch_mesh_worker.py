"""Gloo worlds on the CPU for the port's mesh tests (not collected by pytest).

``run_world(world, n_model, cases, tmp)`` spawns ``world`` processes
(``torch.multiprocessing``, start method ``spawn``), each joining a gloo
group on a free localhost port with a timeout, making a (world / n_model,
n_model) mesh and running every case of ``cases`` in order; it returns the
ranks' results, one dict each (case key -> what the case returned). Each
case is ``fn(mesh, ...)``, ``mesh`` None for a run without one. The module imports torch and the port only, never jax: the
tests that compare with the JAX package import that themselves.
"""

from __future__ import annotations

import copy
import os
import pickle
import socket
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from neurec_tpu_torch.bridge import param_leaves, params_from_numpy, params_to_numpy
from neurec_tpu_torch.data.synthetic import DictConfig, random_dataset
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.trainer import Trainer

WORLD_TIMEOUT_S = 240

EVAL = {"topk": [5, 10], "metric": ["Precision", "Recall", "NDCG"], "test_batch_size": 16}
BATCH = 16

# one small configuration per epoch family, and for each loss term that is
# not a sum over the batch's rows
CONFS = {
    "LightGCN": dict(recommender="LightGCN", embed_size=8, n_layers=2, reg=0.01, lr=0.01, graph_shard="on"),
    "NGCF": dict(recommender="NGCF", embedding_size=8, layer_size=[8, 8], reg=0.01, node_dropout_flag=False,
                 mess_dropout_ratio=0.0, graph_shard="on", learning_rate=0.01),
    "NeuMF": dict(recommender="NeuMF", embedding_size=4, layers=[16, 8, 4], reg_mf=0.01, reg_mlp=0.02,
                  is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "FPMC": dict(recommender="FPMC", embedding_size=8, reg_mf=0.01, is_pairwise=True, loss_function="bpr"),
    "MultiVAE": dict(recommender="MultiVAE", p_dim=[8, 16], reg=0.01, total_anneal_steps=20, anneal_cap=0.2,
                     learning_rate=0.01),
    "SASRec": dict(recommender="SASRec", hidden_units=8, max_len=6, num_blocks=2, num_heads=2, dropout_rate=0.3,
                   l2_emb=0.01, lr=0.01),
    "GRU4Rec": dict(recommender="GRU4Rec", layers=[8], loss="top1", reg=0.01, lr=0.01, batch_size=4),
    "WRMF": dict(recommender="WRMF", embedding_size=8, alpha=10.0, reg_mf=0.1),
    "APR": dict(recommender="APR", embedding_size=8, reg=0.01, reg_adv=1.0, adv="grad", eps=0.5, adv_epoch=0),
    "CDAE": dict(recommender="CDAE", hidden_dim=8, num_neg=2, dropout=0.5, reg=0.01),
    "DAE": dict(recommender="DAE", hidden_neuron=10, corruption_level=0.3, reg=0.01),
    "MF": dict(recommender="MF", embedding_size=8, reg_mf=0.01, learning_rate=0.05, is_pairwise=True,
               loss_function="bpr"),
    "DeepICF": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=True,
                    regs=[0.01, 0.02, 0.03], loss_function="cross_entropy"),
}
FAMILIES = ["LightGCN", "NeuMF", "FPMC", "MultiVAE", "SASRec", "GRU4Rec", "WRMF", "APR", "CDAE", "DAE"]
# the rest of the zoo whose steps split: the terms of each loss that are
# not sums over the batch's rows (the mean's weight count, whole-tensor
# regularisers, batch-shaped dropout) each met once
CONFS.update({
    "MLP": dict(recommender="MLP", layers=[16, 8, 4], reg_mlp=0.01, is_pairwise=False,
                loss_function="cross_entropy", num_neg=2),
    "FISM": dict(recommender="FISM", embedding_size=8, alpha=0.5, is_pairwise=False, loss_function="square",
                 num_neg=2, **{"lambda": 0.01, "gamma": 0.02}),
    "NAIS": dict(recommender="NAIS", embedding_size=8, weight_size=4, regs=[0.01, 0.02, 0.03], alpha=0.3, beta=0.5,
                 algorithm=0, activation=0, is_pairwise=False, loss_function="cross_entropy", num_neg=2),
    "DeepICF-nobn": dict(recommender="DeepICF", embedding_size=8, weight_size=4, layers=[8, 4], batch_norm=False,
                         regs=[0.01, 0.02, 0.03], alpha=0.0, beta=0.5, activation=2, num_neg=2),
    "DMF": dict(recommender="DMF", layers=[16, 8], loss_function="cross_entropy", num_negatives=2),
    "ConvNCF": dict(recommender="ConvNCF", embedding_size=8, net_channel=[4, 4, 4], regs=[0.01, 0.02, 0.03],
                    lr_embed=0.05, lr_net=0.02, keep=0.8),
    "SpectralCF": dict(recommender="SpectralCF", embedding_size=8, num_layers=2, reg=0.01),
    "MultiDAE": dict(recommender="MultiDAE", p_dim=[8, 16], reg=0.01, keep_prob=0.8),
    "FPMCplus": dict(recommender="FPMCplus", embedding_size=8, weight_size=4, high_order=3, reg_mf=0.01,
                     reg_w=0.01, is_pairwise=True, loss_function="BPR"),
    "TransRec": dict(recommender="TransRec", embedding_size=8, reg_mf=0.01, is_pairwise=False,
                     loss_function="cross_entropy", num_neg=2),
    "Fossil": dict(recommender="Fossil", embedding_size=8, alpha=0.5, regs=[0.01, 0.02, 0.03], high_order=2,
                   is_pairwise=False, num_neg=2, loss_function="cross_entropy"),
    "HRM": dict(recommender="HRM", embedding_size=8, reg_mf=0.01, high_order=2, pre_agg="max", session_agg="max",
                num_neg=2),
    "NPE": dict(recommender="NPE", embedding_size=8, reg=0.01, high_order=3, num_neg=2),
    "GRU4RecPlus": dict(recommender="GRU4RecPlus", layers=[8], loss="bpr_max", bpr_reg=1.0, n_sample=12, lr=0.01,
                        batch_size=4),
})
ZOO = ["MLP", "FISM", "NAIS", "DeepICF-nobn", "DMF", "ConvNCF", "SpectralCF", "MultiDAE", "FPMCplus", "TransRec",
       "Fossil", "HRM", "NPE", "GRU4RecPlus"]
# the models no configuration above holds; SBPR and DiffNet read a
# friendship file (``social_trainer``)
CONFS.update({
    "Pop": dict(recommender="Pop"),
    "ItemKNN": dict(recommender="ItemKNN", neighbor=5, similarity="cosine", knn_block=16),
    "JCA": dict(recommender="JCA", hidden_neuron=8, reg=0.01, f_act="tanh", g_act="sigmoid", num_neg=2),
    "CFGAN": dict(recommender="CFGAN", hiddenLayer_G=[12], hiddenLayer_D=[6], batchSize_G=8, batchSize_D=8,
                  step_G=1, step_D=1, mode="userBased", reg_D=0.01),
    "IRGAN": dict(recommender="IRGAN", factors_num=4, d_reg=0.01, g_reg=0.01, lr=0.05),
    "Caser": dict(recommender="Caser", factors_num=8, seq_L=3, seq_T=2, nv=2, nh=3, dropout=0.3, neg_samples=2,
                  l2_reg=0.01, lr=0.01, batch_size=8),
    "SRGNN": dict(recommender="SRGNN", hidden_size=8, max_seq_len=8, lr=0.01, lr_dc_step=1, batch_size=8),
})
SOCIAL_ARGS = {
    "SBPR": ["--embedding_size=8", "--batch_size=32", "--num_epochs=1", "--learning_rate=0.05"],
    "DiffNet": ["--embedding_size=8", "--batch_size=64", "--epochs=1", "--num_negatives=2", "--learning_rate=0.05",
                "--feature_dimension=6", "--user_feature_file=", "--item_feature_file="],
}
# every registered model, each under one configuration
ALL_MODELS = sorted([n for n in CONFS if n != "DeepICF-nobn"] + list(SOCIAL_ARGS))
EPOCHS = 2
# the custom epochs that split their steps over 'data', and of each the
# loss methods that a step calls, the batch's rows their second argument
CUSTOM_DP = ["SBPR", "Caser", "SRGNN", "JCA", "CFGAN", "IRGAN"]
CUSTOM_LOSSES = {"SBPR": ("sbpr_loss",), "Caser": ("caser_loss",), "SRGNN": ("batch_loss",), "JCA": ("step_loss",),
                 "CFGAN": ("d_loss", "g_loss"), "IRGAN": ("_d_loss",)}


class RecordingLogger:
    path = None

    def __init__(self):
        self.warnings = []

    def info(self, msg):
        pass

    def warning(self, msg):
        self.warnings.append(msg)

    debug = error = critical = info


def dataset(seed: int = 3):
    # 40 users, 48 items: batches, user rows and item rows divide 2 and 4
    return random_dataset(num_users=40, num_items=48, min_per_user=4, max_per_user=12, seed=seed)


def conf_dict(name: str, **over) -> dict:
    conf = dict(EVAL, batch_size=BATCH, epochs=EPOCHS, verbose=EPOCHS)
    conf.update(CONFS[name])
    conf.update(over)
    return conf


def conf_for(name: str, **over) -> DictConfig:
    return DictConfig(conf_dict(name, **over))


def make_trainer(name: str, mesh, **over) -> Trainer:
    ds = dataset()
    conf = conf_for(name, **over)
    model = get_model(conf["recommender"])(ds, conf, device="cpu")
    return Trainer(model, ds, conf, logger=RecordingLogger(), seed=11, device="cpu", mesh=mesh)


def train(mesh, name: str, epochs: int = EPOCHS, root: str = None, **over) -> dict:
    """``epochs`` epochs from the seeded init: the epoch losses, the params
    (numpy) and the evaluation string after them. A social model reads its
    files under ``root`` (``social_trainer``)."""
    trainer = social_trainer(mesh, root, name) if name in SOCIAL_ARGS else make_trainer(name, mesh, **over)
    trainer.initialize()
    losses = []
    for epoch in range(1, epochs + 1):
        trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch)
        losses.append(float(loss))
    return {"losses": losses, "params": params_to_numpy(trainer.params, trainer.model.shards),
            "result": trainer.evaluate(), "warnings": getattr(trainer.logger, "warnings", []),
            "sharded": getattr(trainer.model, "_adj_sharded", None) is not None}


def evaluate(mesh, name: str, env: Dict[str, str] = None, group_view=None, params_np=None, **over) -> dict:
    """One evaluation of seeded params (or ``params_np``) under ``env``:
    the string, the tier, the raw metrics and every slot's top-K ids."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        if group_view is not None:
            over["group_view"] = group_view
        trainer = make_trainer(name, mesh, **over)
        trainer.initialize()
        if params_np is None:
            params = trainer.params
        else:
            params = params_from_numpy(params_np, "cpu")
            params = trainer.place(params, trainer.model.param_shardings(mesh, params))
        ev = trainer.evaluator.evaluator
        if group_view is not None:
            return {"result": trainer.evaluator.evaluate(trainer.model.predict, params)}
        ev.record_ids = True
        raw = ev.evaluate_raw(trainer.model.predict, params)
        return {"result": "\t".join(("%.8f" % x).ljust(12) for x in raw.reshape(-1)), "raw": raw,
                "tier": ev._get_program(trainer.model.predict).plan.name, "ids": ev.last_ids.numpy(),
                "n_users": len(ev.test_users),
                "params": params_to_numpy(params, trainer.model.shards)}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spmm_case(mesh, name: str = "LightGCN", seed: int = 5) -> dict:
    """A sharded (or, without a mesh, the plain) SpMM of the model's
    adjacency on seeded x: A @ x and d/dx of sum((A @ x) * W), each rank's
    loss its 'data' rows' part, the gradient summed over 'data' as the
    trainer sums it."""
    from neurec_tpu_torch.ops.graph import maybe_shard, spmm, spmm_sharded
    from neurec_tpu_torch.parallel.mesh import all_sum

    trainer = make_trainer(name, None)
    adj = trainer.model.adj
    rng = np.random.RandomState(seed)
    x_np = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    w_np = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    x = torch.from_numpy(x_np).requires_grad_(True)
    w = torch.from_numpy(w_np)
    if mesh is None:
        out = spmm(adj, x)
        (out * w).sum().backward()
        return {"out": out.detach().numpy(), "grad": x.grad.numpy()}
    sharded = maybe_shard(adj, mesh, "on")
    out = spmm_sharded(sharded, x)
    n, d = mesh.shape["data"], mesh.coordinate["data"]
    rows = slice(d * -(-adj.n_nodes // n), (d + 1) * -(-adj.n_nodes // n))
    (out[rows] * w[rows]).sum().backward()
    return {"out": out.detach().numpy(), "grad": all_sum(x.grad, mesh, "data").numpy(),
            "block": sharded.block, "plan_rows": sharded.plan.n_rows, "plan_t_rows": sharded.plan_t.n_rows}


def batch_shapes(mesh, name: str, root: str = None) -> dict:
    """The leading dimension of every batch tensor and of the weights that
    one step's loss receives; of a custom epoch, the rows each of its loss
    methods (``CUSTOM_LOSSES``) first receives. A social model reads its
    files under ``root``."""
    trainer = social_trainer(mesh, root, name) if name in SOCIAL_ARGS else make_trainer(name, mesh)
    trainer.initialize()
    seen = {}
    real = trainer.model.loss
    for method in CUSTOM_LOSSES.get(name, ()):
        def spy_method(params, rows, *rest, _real=getattr(trainer.model, method), _key=method):
            seen.setdefault(_key, int(rows.shape[0]))
            return _real(params, rows, *rest)

        setattr(trainer.model, method, spy_method)

    def spy(params, batch, weights):
        seen.setdefault("w", int(weights.shape[0]))
        for k in ("users", "pos_items", "neg_items", "items", "labels", "rows", "recent_items"):
            if k in batch:
                seen.setdefault(k, int(batch[k].shape[0]))
        return real(params, batch, weights)

    trainer.model.loss = spy
    trainer.train_epoch(1, max_steps=1)
    return seen


def checkpoint_case(mesh, directory: str, stop: int) -> dict:
    """MF trained with checkpoints into ``directory`` up to epoch ``stop``
    (a fresh trainer resumes what is there): the losses it ran and its
    final params and string."""
    from neurec_tpu_torch.checkpoint import attach_to_trainer

    trainer = make_trainer("MF", mesh, epochs=stop, verbose=1)
    start = attach_to_trainer(trainer, directory)
    losses = []
    moment_rows = {path: [int(t.shape[0]) for k, t in sorted(trainer.opt_state.state[p].items()) if t.dim()]
                   for path, p in param_leaves(trainer.params)}
    for epoch in range(start, stop + 1):
        trainer.params, trainer.opt_state, loss = trainer.train_epoch(epoch)
        losses.append(float(loss))
        trainer._ckpt.save(epoch, trainer.params, trainer.opt_state)
    return {"start": start, "losses": losses, "moment_rows": moment_rows,
            "params": params_to_numpy(trainer.params, trainer.model.shards),
            "result": trainer.evaluate()}


def run_main(mesh, workdir: str, extra=()) -> dict:
    """``run.main`` on a seeded rating file under ``workdir`` (this rank's
    working directory, where the run logger writes): the result string and
    the run logs this rank sees."""
    import glob

    from neurec_tpu_torch import run

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(workdir, "data")
    os.makedirs(data, exist_ok=True)
    path = os.path.join(data, "mesh.rating")
    if mesh is None or mesh.coordinate == {"data": 0, "model": 0}:
        rng = np.random.RandomState(0)
        with open(path + ".tmp", "w") as fout:
            fout.write("".join("%d,%d,1\n" % (u, i) for u in range(40)
                               for i in rng.choice(48, rng.randint(5, 14), replace=False)))
        os.replace(path + ".tmp", path)
    if mesh is not None:
        from neurec_tpu_torch.parallel.distributed import barrier

        barrier()
    os.chdir(workdir)
    args = ["--recommender=MF", "--config_dir=%s" % os.path.join(repo, "conf"), "--data.input.path=%s" % data,
            "--data.cache.path=%s" % os.path.join(workdir, "cache"), "--data.input.dataset=mesh",
            "--data.column.format=UIR", "--data.convert.separator=','", "--epochs=2", "--topk=[5]",
            "--metric=[\"Recall\",\"NDCG\"]", "--batch_size=16", "--test_batch_size=16",
            "--embedding_size=8"] + list(extra)
    trainer, result = run.main(os.path.join(repo, "NeuRec.properties"), args, device="cpu", mesh=mesh)
    return {"result": result, "shards": sorted(trainer.model.shards),
            "logs": sorted(glob.glob(os.path.join(workdir, "log", "*", "MF", "*.log"))),
            "records": sorted(glob.glob(os.path.join(workdir, "log", "*", "MF", "*.metrics.jsonl")))}


def propagate_case(mesh, name: str) -> dict:
    """One epoch of ``name`` (graph_shard=on), then its propagated user
    table and params."""
    trainer = make_trainer(name, mesh, graph_shard="on")
    trainer.initialize()
    trainer.params, trainer.opt_state, loss = trainer.train_epoch(1)
    with torch.no_grad():
        u_table, _ = trainer.model.propagate(trainer.params)
    return {"loss": float(loss), "table": u_table.numpy(),
            "params": params_to_numpy(trainer.params, trainer.model.shards),
            "sharded": trainer.model._adj_sharded is not None}


def segment_branch_case(mesh) -> dict:
    """A block's plan branch against its segment-sum branch (no plans)."""
    from neurec_tpu_torch.ops.graph import maybe_shard, spmm_sharded

    adj = make_trainer("LightGCN", None).model.adj
    sharded = maybe_shard(adj, mesh, "on")
    x = torch.from_numpy(np.random.RandomState(2).standard_normal((adj.n_nodes, 8)).astype(np.float32))
    return {"plan": spmm_sharded(sharded, x).numpy(),
            "segment": spmm_sharded(sharded._replace(plan=None, plan_t=None), x).numpy()}


def item_shard_auto_case(mesh) -> dict:
    """``eval_item_shard=auto`` with a score-block budget whose threshold
    (40 items) lies below the test catalogue (48)."""
    from neurec_tpu_torch.eval import tiers

    old = tiers.SCORE_BLOCK_BUDGET
    tiers.SCORE_BLOCK_BUDGET = 4 * EVAL["test_batch_size"] * 40
    try:
        return evaluate(mesh, "MF", eval_item_shard="auto")
    finally:
        tiers.SCORE_BLOCK_BUDGET = old


def social_trainer(mesh, root: str, name: str) -> Trainer:
    """A trainer of ``name`` (SBPR or DiffNet) on a seeded rating file and
    a seeded friendship file under ``root`` (the primary rank writes
    them)."""
    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.data.dataset import Dataset

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if mesh is None or mesh.coordinate == {"data": 0, "model": 0}:
        os.makedirs(root, exist_ok=True)
        rng = np.random.RandomState(0)
        with open(os.path.join(root, "soc.rating.tmp"), "w") as fout:
            fout.write("".join("%d,%d,1\n" % (u, i) for u in range(40)
                               for i in rng.choice(50, rng.randint(4, 14), replace=False)))
        with open(os.path.join(root, "soc.uu.tmp"), "w") as fout:
            fout.write("".join("%d,%d\n" % (u, v) for u in range(40) for v in rng.choice(40, 4, replace=False)))
        for fname in ("soc.rating", "soc.uu"):
            os.replace(os.path.join(root, fname + ".tmp"), os.path.join(root, fname))
    if mesh is not None:
        from neurec_tpu_torch.parallel.distributed import barrier

        barrier()
    cache = os.path.join(root, "cache%d" % (0 if mesh is None else 1 + mesh.coordinate["data"] * 2
                                             + mesh.coordinate["model"]))
    conf = Config(os.path.join(repo, "NeuRec.properties"), cmd_args=[
        "--recommender=%s" % name, "--config_dir=%s" % os.path.join(repo, "conf"), "--data.input.path=%s" % root,
        "--data.cache.path=%s" % cache, "--data.input.dataset=soc", "--data.column.format=UIR",
        "--data.convert.separator=','", "--splitter=ratio", "--ratio=0.8", "--by_time=False", "--user_min=0",
        "--item_min=0", "--social_file=%s" % os.path.join(root, "soc.uu"), "--topk=[5]",
        "--metric=[\"Recall\",\"NDCG\"]", "--test_batch_size=16"] + SOCIAL_ARGS[name])
    ds = Dataset(conf)
    return Trainer(get_model(name)(ds, conf, device="cpu"), ds, conf, logger=RecordingLogger(), seed=11,
                   device="cpu", mesh=mesh)


def diffnet_case(mesh, root: str) -> dict:
    """DiffNet (the pointwise epoch over social and consumption segment
    sums) one epoch on a seeded rating file and a seeded friendship file
    under ``root`` (the primary rank writes them): the losses, params and
    string."""
    trainer = social_trainer(mesh, root, "DiffNet")
    trainer.initialize()
    trainer.params, trainer.opt_state, loss = trainer.train_epoch(1)
    return {"losses": [float(loss)], "params": params_to_numpy(trainer.params, trainer.model.shards),
            "result": trainer.evaluate()}


ZOO_STEPS = 3


def zoo_case(mesh, name: str, root: str, steps: int = ZOO_STEPS) -> dict:
    """``name`` from its seeded init (``init``, gathered whole), one epoch
    cut to its first ``steps`` steps (each pass of a custom epoch), then
    evaluated: the losses, the params (gathered whole), the string, and of
    every leaf sharded over 'model' this rank's block before and after the
    steps, its first row, the whole table's rows and its storage's bytes."""
    trainer = social_trainer(mesh, root, name) if name in SOCIAL_ARGS else make_trainer(name, mesh)
    trainer.initialize()
    model = trainer.model

    def blocks():
        return {path: leaf.detach().numpy().copy() for path, leaf in param_leaves(trainer.params)
                if path in model.shards}

    placed = {path: {"lo": model.shards[path].lo, "rows": model.shards[path].rows,
                     "storage": leaf.untyped_storage().nbytes(), "nbytes": leaf.numel() * leaf.element_size()}
              for path, leaf in param_leaves(trainer.params) if path in model.shards}
    # copies: on the CPU a numpy view would follow the steps' in-place updates
    init, before = copy.deepcopy(params_to_numpy(trainer.params, model.shards)), blocks()
    losses = []
    if model.data_kind != "none":
        trainer.params, trainer.opt_state, loss = trainer.train_epoch(1, max_steps=steps)
        losses.append(float(loss))
    return {"losses": losses, "init": init, "placed": placed, "before": before, "after": blocks(),
            "params": params_to_numpy(trainer.params, model.shards), "result": trainer.evaluate()}


def resident_bytes(mesh, name: str = "MF") -> dict:
    """The bytes this rank holds of ``name``'s params and of its Adam
    state after one step (each tensor's storage)."""
    trainer = make_trainer(name, mesh)
    trainer.initialize()
    trainer.params, trainer.opt_state, _ = trainer.train_epoch(1, max_steps=1)
    leaves = [p for _, p in param_leaves(trainer.params)]
    moments = [t for p in leaves for k, t in trainer.opt_state.state[p].items() if k in ("exp_avg", "exp_avg_sq")]
    return {"params": sum(p.untyped_storage().nbytes() for p in leaves),
            "adam": sum(t.untyped_storage().nbytes() for t in moments),
            "shards": sorted(trainer.model.shards)}


def pretrain_case(mesh, path: str) -> dict:
    """MF's params written by ``save_pretrain`` from every rank, and the
    numpy params (``params_to_numpy``), both whole."""
    from neurec_tpu_torch.pretrain import save_pretrain
    from neurec_tpu_torch.parallel.distributed import barrier

    trainer = make_trainer("MF", mesh)
    trainer.initialize()
    save_pretrain("MF", trainer.params, path, trainer.model.shards)
    barrier()
    with open(path, "rb") as fin:
        written = pickle.load(fin)
    return {"written": written, "params": params_to_numpy(trainer.params, trainer.model.shards)}


def native_refused(mesh) -> bool:
    """True where the native backend refuses a world of more than one
    process with the single-process text."""
    try:
        make_trainer("MF", mesh, eval_backend="native")
    except ValueError as e:
        return "single-process only" in str(e)
    return False


def graph_sharded(mesh, mode: str) -> bool:
    """Whether LightGCN under ``graph_shard=mode`` holds a sharded graph."""
    return make_trainer("LightGCN", mesh, graph_shard=mode).model._adj_sharded is not None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank: int, world: int, port: int, n_model: int, cases: List, out_dir: str):
    from neurec_tpu_torch.parallel.distributed import initialize_multihost, shutdown
    from neurec_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    results = {}
    try:
        initialize_multihost("127.0.0.1:%d" % port, world, rank, backend="gloo", timeout_s=WORLD_TIMEOUT_S)
        mesh = make_mesh(n_model=n_model)
        for key, fn, args, kwargs in cases:
            results[key] = fn(mesh, *args, **kwargs)
    except BaseException:  # reported through the result file, then re-raised
        results["__error__"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fout:
            pickle.dump(results, fout)
        shutdown()


def run_world(world: int, n_model: int, cases: List, out_dir: str, timeout_s: float = WORLD_TIMEOUT_S) -> List[dict]:
    """Run ``cases`` (``(key, fn, args, kwargs)``, ``fn(mesh, *args,
    **kwargs)``) on each rank of a gloo world; returns the ranks' result
    dicts. Raises with the first rank's traceback where one failed, and
    after ``timeout_s`` (the processes are killed)."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_worker, args=(world, _free_port(), n_model, cases, out_dir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError("the gloo world did not finish in %d s" % timeout_s)
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errors = []
        for r in range(world):
            path = os.path.join(out_dir, "rank%d.pkl" % r)
            if os.path.exists(path):
                with open(path, "rb") as fin:
                    err = pickle.load(fin).get("__error__")
                if err:
                    errors.append("rank %d:\n%s" % (r, err))
        if errors:
            raise RuntimeError("\n".join(errors))
        raise
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as fin:
            out.append(pickle.load(fin))
    return out


def leaves(params_np) -> Dict[tuple, np.ndarray]:
    return {path: np.asarray(v) for path, v in param_leaves(params_np)}

