"""neurec_tpu_torch — the PyTorch/CUDA port of neurec_tpu for NVIDIA Hopper.

The JAX package ``neurec_tpu`` is the reference; this package mirrors its
layout and names (``ops/graph.py`` here is ``neurec_tpu/ops/graph.py``
there) and keeps its functional model protocol: parameters are a plain
dict of tensors keyed exactly as the JAX params, so
``Evaluator.evaluate(model.predict, params)`` and
``batch_topk(model, params, k, ...)`` are called the same way in both.

Rules of the port:

* it imports torch, numpy and scipy — never jax, and nothing of
  ``neurec_tpu`` (it keeps its own copies of the host code it needs);
* every Pallas TPU kernel on a ported path is a hand-written CUDA kernel
  for ``sm_90a`` under ``csrc/``, built at first use (``ops/_build.py``),
  with its plain PyTorch version in the same module; the wrapper takes the
  plain version only for a tensor that lies on the CPU;
* entry points take ``device=None``, meaning ``cuda``, and raise when no
  CUDA device exists — a CPU run has to ask for ``device="cpu"``.
"""

__version__ = "0.1.0"

from neurec_tpu_torch.config import Config  # noqa: F401
