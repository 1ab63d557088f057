"""Entry point: ``python -m neurec_tpu_torch.run --recommender=MF [--k=v ...]``.

Port of ``neurec_tpu/run.py`` (the reference main.py:10-45): fixed seeds,
properties + CLI config, dataset load, model resolution by name, train.
``device=None`` means cuda (see ``device.py``). ``--ckpt_dir=<dir>
[--ckpt_every=N]``: a checkpoint every N epochs (``checkpoint.py``) and
auto-resume, so the same command after a crash goes on from the last saved
epoch. ``--trace_dir=<dir>``: a ``torch.profiler`` trace of the run
(``profiling.py``). ``--scan_unroll=N``: the steps each CUDA graph of a
built-in epoch holds on the card (``Trainer``, ``step_graph.py``), read
as the JAX package's trainer reads it.

The mesh (``neurec_tpu/run.py:32-37``): under ``torchrun
--nproc_per_node=N -m neurec_tpu_torch.run ...`` every process joins the
group (``parallel.distributed.initialize_multihost``: NCCL where each rank
has a card of its own, gloo otherwise), runs on ``cuda:LOCAL_RANK``, and a
('data', 'model') mesh is made when the world holds more than one rank or
``--mesh.model_axis`` is above 1; ``make_mesh`` raises where the axes do not
cover the ranks (``mesh.model_axis=2`` on one rank). The mesh reaches the
Trainer, which row-shards the id tables over 'model'
(``Recommender.param_shardings``), and through it the evaluator;
``--graph_shard`` and ``--eval_item_shard`` choose the sharded graph and
evaluation.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from neurec_tpu_torch import checkpoint
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.logging import run_logger
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.parallel.distributed import barrier, initialize_multihost, is_primary_host, local_rank
from neurec_tpu_torch.parallel.mesh import Mesh, make_mesh
from neurec_tpu_torch.trainer import Trainer


def main(properties: str = "NeuRec.properties", cmd_args=None, device: DeviceLike = None,
         mesh: Optional[Mesh] = None):
    """Train the configured model; returns ``(trainer, result string)``.
    ``mesh`` given is used as it is (a caller that made its own group);
    otherwise one is made as described above."""
    np.random.seed(2018)
    random.seed(2018)

    conf = Config(properties, default_section="hyperparameters", cmd_args=cmd_args)
    if mesh is None:
        _, world = initialize_multihost()
        n_model = int(conf.get("mesh.model_axis", 1))
        if world > 1 or n_model > 1:
            mesh = make_mesh(n_model=n_model, world=world)
    if device is None and torch.cuda.is_available() and mesh is not None and mesh.backend == "nccl":
        device = "cuda:%d" % local_rank()  # the rank's own card
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    # the primary rank writes the split cache, the others read it after
    if not is_primary_host():
        barrier()
    dataset = Dataset(conf)
    if is_primary_host():
        barrier()
    model = get_model(conf["recommender"])(dataset, conf, device=device)
    logger = run_logger(conf, dataset.dataset_name) if is_primary_host() else None
    if logger is not None:
        logger.info(str(dataset))
    trainer = Trainer(model, dataset, conf, logger=logger, device=device, mesh=mesh)

    ckpt_dir = conf.get_raw("ckpt_dir", None) or None
    if ckpt_dir:
        start = checkpoint.attach_to_trainer(trainer, str(ckpt_dir), every=int(conf.get("ckpt_every", 1)))
        trainer.logger.info("checkpointing to %s every %d epoch(s); starting at epoch %d"
                            % (ckpt_dir, trainer._ckpt_every, start))
    try:
        result = trainer.train()
    finally:
        ckpt = getattr(trainer, "_ckpt", None)
        if ckpt is not None:
            ckpt.close()
    return trainer, result


if __name__ == "__main__":
    main()
