"""The yardstick's arithmetic: the card's published peaks, and the bytes
and operations a kernel's call needs, counted from its shapes.

Peaks are NVIDIA's for one H100 SXM at its 700 W limit (data sheet, dense
rates). A call's bytes count each input read once and each output written
once, whatever the kernel reads again; its operations are the products the
mathematics asks for. The model FLOPs of a configuration's step lie in
``counts/<reference>.py``, named as the configuration's reference.
"""

from __future__ import annotations

import importlib

HBM_BYTES_PER_S = 3.35e12
# dense TF32 on the tensor cores: the fastest product of any f32-input kind
TF32_FLOPS = 495e12


def model(reference: str):
    """The module of a configuration's model FLOPs."""
    return importlib.import_module("perfbench.counts." + reference)


def spmm_bytes(n_nodes: int, nnz: int, d: int) -> float:
    """An (n x n) sparse adjacency times an (n x d) float32 table: the
    table read once, the product written once, each edge's column index
    and value (4 bytes each) read once, the n + 1 row offsets once."""
    return 4.0 * d * n_nodes * 2 + 8.0 * nnz + 4.0 * (n_nodes + 1)


def k1_bytes(batch: int, items: int, d: int) -> float:
    """K1, the masked scores of a batch: the user rows and the item table
    read once, one mask bit a (user, item) read once, the (batch, items)
    float32 scores written once."""
    return 4.0 * batch * d + 4.0 * items * d + batch * -(-items // 8) + 4.0 * batch * items


def k1_flops(batch: int, items: int, d: int) -> float:
    return 2.0 * batch * items * d


def topk_bytes(batch: int, items: int, k: int) -> float:
    """The top-K of a (batch, items) float32 block: the block read once,
    k values and k 4-byte ids a row written once."""
    return 4.0 * batch * items + 8.0 * batch * k


def bound_s(n_bytes: float, n_flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the TF32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / TF32_FLOPS)
