"""Differentiable quantization ops with straight-through gradients (port
of gscodec_studio_tpu/compression_sim/ops.py).

The straight-through estimator is ``x + (fq - x).detach()``: the value of
``fq`` with the gradient of ``x``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def log_transform(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(torch.abs(y))


def fake_quantize_ste(
    x: torch.Tensor,
    lower_bd: float,
    upper_bd: float,
    bitwidth: int = 8,
    q_type: str = "round",
    uniform: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, float]:
    """Uniform fake quantization onto 2^bitwidth levels in [lower, upper].
    Returns (quantized value with straight-through gradients, q_step).
    ``q_type="noise"`` adds ``uniform * q_step`` to the clipped value
    instead, ``uniform`` being the caller's U(-0.5, 0.5) draw of x's
    shape."""
    q_step = (upper_bd - lower_bd) / (2 ** bitwidth - 1)
    xc = torch.clamp(x, lower_bd, upper_bd)
    if q_type == "round":
        # times the float32 reciprocal of the step, as XLA compiles the
        # JAX package's division by a constant inside its jitted training
        # step: a value on a half level (0 in a symmetric range) rounds as
        # it does there
        recip = float(np.float32(1.0) / np.float32(q_step))
        level = torch.round((xc - lower_bd) * recip)
        fq = level * q_step + lower_bd
        return x + (fq - x).detach(), q_step
    if q_type == "noise":
        if uniform is None:
            raise ValueError("q_type='noise' needs its uniform draw")
        return xc + uniform * q_step, q_step
    raise ValueError(q_type)


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} with pass-through gradients inside [-1, 1]."""
    out = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    xm = x * (torch.abs(x) <= 1.0).to(x.dtype)
    return xm + (out - xm).detach()
