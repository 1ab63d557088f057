"""The device rule of the port: CUDA unless the caller asks for the CPU.

There is no silent fallback: an entry point called with ``device=None`` on
a machine without a CUDA device raises instead of running on the CPU.

The card set-up: a CUDA device resolved here runs f32 products in full
f32. TF32 is off for cuBLAS and for cuDNN (which PyTorch lets take TF32 by
default), so no f32 matmul or convolution of the port runs as one TF32
pass, whichever entry point reached the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and no CUDA device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "neurec_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
