"""HSTU's model FLOPs, at the real positions and pairs only (a pad
position or a pair past the causal mask is no work of the model): a layer
is the fused projection (2 d (2 h dv + 2 h dqk) a position), the output
projection (2 h dv d a position) and the attention (2 h (dqk + dv) a
causal pair: the scores and A v); a score a dot product of width d.

``attn_bytes`` and ``attn_flops`` are one attention call's, the bound of
``hstu_attn_roofline``, over histories of ``lengths`` real positions: q, k
and v read once and the output written once at the real positions alone
(a pad row is no work: a jagged layout reads and writes none), the
lengths, each history's times and its query's, the two bias tables and
the bucket edges read once; 2 h (dqk + dv) operations a causal pair."""

import numpy as np


def _widths(hyper: dict):
    return (int(hyper["item_embedding_dim"]), int(hyper["num_heads"]), int(hyper["dqk"]), int(hyper["dv"]),
            int(hyper["num_blocks"]), int(hyper["max_sequence_length"]))


def causal_pairs(lengths) -> int:
    n = np.asarray(lengths, dtype=np.int64)
    return int(np.sum(n * (n + 1) // 2))


def attn_flops(hyper: dict, lengths) -> float:
    _, h, dqk, dv, _, _ = _widths(hyper)
    return 2.0 * h * (dqk + dv) * causal_pairs(lengths)


def attn_bytes(hyper: dict, lengths) -> float:
    _, h, dqk, dv, _, N = _widths(hyper)
    n = np.minimum(np.asarray(lengths, dtype=np.int64), N)
    rows = float(np.sum(n))
    return (4.0 * rows * h * (2 * dqk + dv) + 4.0 * rows * h * dv + 4.0 * len(n) + 8.0 * (rows + len(n))
            + 4.0 * (2 * N - 1 + 129) + 8.0 * 128)


def encode_flops(hyper: dict, lengths) -> float:
    """The encoder over histories of ``lengths`` real positions."""
    d, h, dqk, dv, layers, _ = _widths(hyper)
    positions = float(np.sum(np.asarray(lengths, dtype=np.int64)))
    per_position = 2.0 * d * 2 * h * (dv + dqk) + 2.0 * h * dv * d
    return layers * (per_position * positions + attn_flops(hyper, lengths))


def score_flops(hyper: dict, users: int, items: int) -> float:
    return 2.0 * users * items * int(hyper["item_embedding_dim"])
