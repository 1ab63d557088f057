"""Shared machinery of the dense-row autoencoders (MultiDAE, MultiVAE, DAE,
CDAE); port of ``neurec_tpu/models/general/ae_common.py``.

The reference builds the dense (B, num_items) user rows on the host for
each batch (MultiVAE.py:152-165, DAE.py:95-100); here each model keeps the
padded per-user positive rows on its device and scatters the dense rows
there.
"""

from __future__ import annotations

import torch

from neurec_tpu_torch.data.padded import build_padded_positives, dense_rows
from neurec_tpu_torch.parallel.mesh import split_draw


class DenseRowMixin:
    """Adds device-side train-row reconstruction to a Recommender."""

    def _setup_rows(self, dataset):
        padded = build_padded_positives(dataset.train_matrix)
        self._padded_items = torch.from_numpy(padded.items).long().to(self.device)  # pad == num_items
        self._padded_lens = torch.from_numpy(padded.lengths).to(self.device)

    def make_rows(self, users: torch.Tensor) -> torch.Tensor:
        """(B, num_items) float32 binary interaction rows for ``users``."""
        return dense_rows(self._padded_items[users], self.num_items)

    # The draws a loss makes (dropout, corruption, the VAE's noise), one
    # method each, from the step's generator (``batch["generator"]``). They
    # are torch's, not JAX's threefry: the packages agree in distribution.
    # Each has the batch's leading dimension: a data-parallel step draws it
    # for the whole batch and keeps this rank's rows (``split_draw``).
    @staticmethod
    def _bernoulli(generator: torch.Generator, p: float, shape) -> torch.Tensor:
        """Bool, True with probability ``p`` (``jax.random.bernoulli``)."""
        return split_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape) < p

    @staticmethod
    def _normal(generator: torch.Generator, shape) -> torch.Tensor:
        return split_draw(lambda s: torch.randn(s, generator=generator, device=generator.device), shape)

    def _dropout(self, x: torch.Tensor, generator: torch.Generator, keep: float) -> torch.Tensor:
        """Inverted dropout: kept entries scaled by 1 / keep, zeros stay zero."""
        return torch.where(self._bernoulli(generator, keep, x.shape), x / keep, torch.zeros_like(x))
