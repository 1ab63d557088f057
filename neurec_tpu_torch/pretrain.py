"""Pretrain pickles for the warm starts (port of ``neurec_tpu/pretrain.py``).

A pretrain file is a pickle of a list of numpy arrays in the consumer's
layout. ``save_pretrain`` writes it from a producing model's params,
keyed by that model's param names (``_LAYOUTS``); ``try_load`` reads it
for the consumer and logs the outcome as the reference does ("load
pretrained params successful!/unsuccessful!"). The files are the JAX
package's: either package reads what the other writes, to the same arrays.

    save_pretrain("MF", trainer.params, "pretrained/gowalla_mf.pkl")
    # then: python -m neurec_tpu_torch.run --recommender=NeuMF --mf_pretrain=...
"""

from __future__ import annotations

import logging
import os
import pickle
import sys

import numpy as np
import torch

from neurec_tpu_torch.parallel.distributed import is_primary_host
from neurec_tpu_torch.parallel.tables import gather_tree

log = logging.getLogger("neurec_tpu_torch.pretrain")
if not log.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(_handler)
    log.setLevel(logging.INFO)
    log.propagate = False

# model name -> param keys pickled, in the order the consumer indexes them
_LAYOUTS = {
    # NeuMF.mf_pretrain / ConvNCF.mf_pretrain / NGCF.pretrain_file
    "MF": ("user_emb", "item_emb"),
    "GMF": ("user_emb", "item_emb"),
    # NeuMF.mlp_pretrain
    "MLP": ("mlp_user", "mlp_item"),
    # NAIS.pretrain_file / DeepICF.pretrain_file ([c1, embedding_Q, bias])
    "FISM": ("Q_set", "Q", "bias"),
    # IRGAN.pretrain_file (generator [user_emb, item_emb, bias])
    "IRGAN": ("gen.user_emb", "gen.item_emb", "gen.item_bias"),
}


def _resolve(params, dotted: str):
    node = params
    for part in dotted.split("."):
        node = node[part]
    return node


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pretrain(model_name: str, params: dict, path: str, shards=None) -> None:
    """Pickle the warm-start arrays of ``model_name`` in consumer layout.

    Under a mesh whose tables are row-sharded over 'model' (``shards``,
    the producer's ``Recommender.shards``) every rank calls it: the tables
    are gathered whole (a collective), and the primary rank writes."""
    try:
        keys = _LAYOUTS[model_name]
    except KeyError:
        raise ValueError(
            "no pretrain layout for %r (have: %s)" % (model_name, ", ".join(sorted(_LAYOUTS)))
        ) from None
    if shards:
        params = gather_tree(params, shards)
        if not is_primary_host():
            return
    payload = [_as_numpy(_resolve(params, k)) for k in keys]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fout:
        pickle.dump(payload, fout)


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


def as_tensor(array, device) -> torch.Tensor:
    """A loaded array as an f32 tensor on ``device``, a copy."""
    return torch.tensor(np.asarray(array), dtype=torch.float32, device=device)
