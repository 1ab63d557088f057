"""Pretrain pickles for a model's warm start (port of the loading half of
``neurec_tpu/pretrain.py``).

A pretrain file is a pickle of a list of numpy arrays in the consumer's
layout (NGCF's ``pretrain_file``: ``[user_emb, item_emb]``, the MF layout
``neurec_tpu.pretrain.save_pretrain`` writes). The outcome is logged as the
reference does ("load pretrained params successful!/unsuccessful!").
"""

from __future__ import annotations

import logging
import pickle
import sys

log = logging.getLogger("neurec_tpu_torch.pretrain")
if not log.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(_handler)
    log.setLevel(logging.INFO)
    log.propagate = False


def load_pretrain(path: str):
    """Load a pretrain pickle (list of arrays)."""
    with open(path, "rb") as fin:
        return pickle.load(fin, encoding="utf-8")


def try_load(*paths):
    """A list of payloads (one per path), or None.

    Empty or unset paths mean no warm start: a silent None. A file that
    cannot be read or unpickled logs "unsuccessful" and gives None, so the
    model trains from its own init, like the reference.
    """
    if not paths or not all(paths):
        return None
    try:
        out = [load_pretrain(p) for p in paths]
    except Exception:
        log.info("load pretrained params unsuccessful! (%s)" % ", ".join(paths))
        return None
    log.info("load pretrained params successful! (%s)" % ", ".join(paths))
    return out
