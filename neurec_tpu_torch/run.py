"""Entry point: ``python -m neurec_tpu_torch.run --recommender=MF [--k=v ...]``.

Port of ``neurec_tpu/run.py`` (the reference main.py:10-45): fixed seeds,
properties + CLI config, dataset load, model resolution by name, train.
One device, ``device=None`` meaning cuda (see ``device.py``); there is no
mesh. ``--ckpt_dir=<dir> [--ckpt_every=N]``: a checkpoint every N epochs
(``checkpoint.py``) and auto-resume, so the same command after a crash
goes on from the last saved epoch. ``--trace_dir=<dir>``: a
``torch.profiler`` trace of the run (``profiling.py``).
"""

from __future__ import annotations

import random

import numpy as np

from neurec_tpu_torch import checkpoint
from neurec_tpu_torch.config import Config
from neurec_tpu_torch.data.dataset import Dataset
from neurec_tpu_torch.device import DeviceLike, resolve_device
from neurec_tpu_torch.logging import run_logger
from neurec_tpu_torch.models import get_model
from neurec_tpu_torch.trainer import Trainer


def main(properties: str = "NeuRec.properties", cmd_args=None, device: DeviceLike = None):
    """Train the configured model; returns ``(trainer, result string)``."""
    device = resolve_device(device)
    np.random.seed(2018)
    random.seed(2018)

    conf = Config(properties, default_section="hyperparameters", cmd_args=cmd_args)
    dataset = Dataset(conf)
    model = get_model(conf["recommender"])(dataset, conf, device=device)
    logger = run_logger(conf, dataset.dataset_name)
    logger.info(str(dataset))
    trainer = Trainer(model, dataset, conf, logger=logger, device=device)

    ckpt_dir = conf.get_raw("ckpt_dir", None) or None
    if ckpt_dir:
        start = checkpoint.attach_to_trainer(trainer, str(ckpt_dir), every=int(conf.get("ckpt_every", 1)))
        logger.info("checkpointing to %s every %d epoch(s); starting at epoch %d"
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
