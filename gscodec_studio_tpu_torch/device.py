"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and there
    is none: the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gscodec_studio_tpu_torch renders on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
