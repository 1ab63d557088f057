"""Shared state and draws of the sequential models (port of
``neurec_tpu/models/sequential/seq_common.py``).

At evaluation the time-order models (FPMC, FPMCplus, TransRec, Fossil, HRM,
NPE) condition every score on the user's last ``high_order`` training
items (e.g. FPMC.py:139-146). They live on the model's device as a
(num_users, high_order) table built once from the by-time train dict.

``SeqDraws`` gathers the draws the sequential losses and custom epochs
make, one method each, from a ``torch.Generator`` on the model's device:
a test hands in the JAX package's draws there. They are torch's (Philox
on a CUDA device), not JAX's threefry: the packages agree in
distribution, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from neurec_tpu_torch.ops.sampling import sample_negatives
from neurec_tpu_torch.parallel.mesh import split_draw


class SequentialMixin:
    high_order: int = 1

    def _setup_recent(self, dataset):
        """``_recent_items`` (U, high_order) int64: the last ``high_order``
        train items of each user, oldest first; a shorter history is
        left-padded with its earliest item, a user without one holds 0
        (``_has_history`` False)."""
        train_dict = dataset.get_user_train_dict(by_time=True)
        recent = np.zeros((self.num_users, self.high_order), dtype=np.int64)
        has = np.zeros(self.num_users, dtype=bool)
        for u, seq in train_dict.items():
            tail = seq[-self.high_order:]
            if not tail:
                continue
            recent[u] = [tail[0]] * (self.high_order - len(tail)) + list(tail)
            has[u] = True
        self._recent_items = torch.from_numpy(recent).to(self.device)
        self._has_history = torch.from_numpy(has).to(self.device)


class SeqDraws:
    """The draws of a sequential loss or epoch."""

    @staticmethod
    def _perm(generator: torch.Generator, n: int) -> torch.Tensor:
        """A permutation of ``range(n)`` on the generator's device."""
        return torch.randperm(n, generator=generator, device=generator.device)

    def _epoch_slots(self, generator: torch.Generator, n: int):
        """``(idx, w)``, (steps, batch_size) each: a permutation of
        ``steps * batch_size`` slots over ``n`` instances, the slots past
        them instance 0 with weight 0."""
        B = self.batch_size
        steps = -(-n // B)
        perm = self._perm(generator, steps * B)
        idx = torch.where(perm < n, perm, torch.zeros_like(perm)).reshape(steps, B)
        return idx, (perm < n).float().reshape(steps, B)

    # ``_bernoulli`` and ``_uniform`` take shapes with the batch's leading
    # dimension: a data-parallel step draws them for the whole batch and
    # keeps this rank's rows (``split_draw``)
    @staticmethod
    def _bernoulli(generator: torch.Generator, p: float, shape) -> torch.Tensor:
        """Bool, True with probability ``p`` (``jax.random.bernoulli``)."""
        return split_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape) < p

    @staticmethod
    def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
        """U[0, 1) float32 (``jax.random.uniform``)."""
        return split_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape)

    def _negatives(self, generator: torch.Generator, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(B, n) int64 negatives of each row of ``rows`` (B, L), excluding
        the row's items (``ops/sampling.py``)."""
        return sample_negatives(generator, rows, self.num_items, (n,)).long()

    def _dropout(self, x: torch.Tensor, generator, rate: float) -> torch.Tensor:
        """Inverted dropout at ``rate``; none without a generator or at rate 0."""
        if generator is None or rate <= 0:
            return x
        keep = 1.0 - rate
        return torch.where(self._bernoulli(generator, keep, x.shape), x / keep, torch.zeros_like(x))
