"""Parameters between the packages: numpy arrays <-> torch tensors.

The JAX package's parameters (``{name: jnp.ndarray}``) leave JAX as numpy
(``np.asarray``) and enter the port here, and back. Dtypes are kept.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neurec_tpu_torch.device import DeviceLike, resolve_device


def params_from_numpy(
    params: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.ascontiguousarray(value)).to(dev)
        for name, value in params.items()
    }


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: value.detach().cpu().numpy() for name, value in params.items()}
