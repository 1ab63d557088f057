"""Negative sampling with per-user exclusion, on the device.

Port of ``neurec_tpu/ops/sampling.py``, which replaces the reference's
host-side Cython rejection sampler (util/cython/random_choice.pyx:20-89).
Membership is a broadcast compare of the candidates against the padded
per-user positive rows (``data/padded.py``, padded with ``num_items``,
which never equals a candidate in ``[0, num_items)``).

The contract is the JAX package's: ``num_rounds`` candidate draws per slot,
take the first that is not in the row, and fall back to the round-0 draw
when every round collides. With density d (positives / num_items) that
happens with probability d**num_rounds (~1.5e-5 at 16 rounds and d = 0.5).
The draws come from a ``torch.Generator`` (Philox on a CUDA device), not
JAX's threefry: the two packages agree in distribution, not draw for draw.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.parallel.mesh import split_draw


def is_positive(
    rows: torch.Tensor,        # (B, L) padded positive rows (pad = num_items)
    candidates: torch.Tensor,  # (B, ...) candidate item ids
) -> torch.Tensor:
    """Per-row membership: True where a candidate is in the row's positives."""
    cand2d = candidates.reshape(candidates.shape[0], -1)  # (B, S)
    member = (rows[:, None, :] == cand2d[:, :, None]).any(dim=-1)
    return member.reshape(candidates.shape)


def sample_negatives(
    generator: torch.Generator,
    rows: torch.Tensor,         # (B, L) per-slot exclusion rows
    num_items: int,
    shape: tuple,               # trailing shape per row, e.g. () or (neg_num,)
    num_rounds: int = 16,
) -> torch.Tensor:
    """Uniform negatives in [0, num_items) excluding each row's positives.

    Returns an int32 tensor of shape (B, *shape) on ``rows``' device, which
    must be the generator's.
    """
    B = rows.shape[0]
    S = 1
    for d in shape:
        S *= d
    # in a data-parallel step: drawn for the whole batch, this rank's rows kept
    draws = split_draw(lambda shape: torch.randint(
        0, num_items, shape, generator=generator, device=rows.device, dtype=torch.int32
    ), (B, num_rounds, S))
    member = is_positive(rows, draws)
    # first free round per slot; argmax gives 0 (the round-0 draw) when none is
    first = torch.argmax((~member).to(torch.uint8), dim=1, keepdim=True)  # (B, 1, S)
    chosen = torch.gather(draws, 1, first)[:, 0]
    return chosen.reshape((B,) + tuple(shape))


def sample_negatives_flat(
    generator: torch.Generator,
    user_ids: torch.Tensor,       # (N,) users of each training instance
    padded_items: torch.Tensor,   # (U, L) global padded positives
    num_items: int,
    shape: tuple = (),
    num_rounds: int = 16,
) -> torch.Tensor:
    """Negatives for a flat batch of (user,) instances: gathers each
    instance's exclusion row, then ``sample_negatives``."""
    rows = padded_items[user_ids.long()]
    return sample_negatives(generator, rows, num_items, shape, num_rounds)
