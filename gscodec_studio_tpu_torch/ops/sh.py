"""Spherical-harmonics colors, Sloan fast basis, degree <= 4 (port of
gscodec_studio_tpu/ops/sh.py: same constants and signs, so trained
checkpoints interchange)."""

from __future__ import annotations

from typing import Optional

import torch


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """dirs [..., 3] (not necessarily unit) -> [..., (degree+1)^2]."""
    if not 0 <= degree <= 4:
        raise ValueError(f"degree must be in [0, 4], got {degree}")
    shape = dirs.shape[:-1]
    out = [torch.full(shape, 0.2820947917738781, dtype=dirs.dtype,
                      device=dirs.device)]
    if degree >= 1:
        inorm = 1.0 / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1),
                                  min=1e-12)
        x = dirs[..., 0] * inorm
        y = dirs[..., 1] * inorm
        z = dirs[..., 2] * inorm
        out += [-0.48860251190292 * y, 0.48860251190292 * z,
                -0.48860251190292 * x]
    if degree >= 2:
        z2 = z * z
        fTmp0B = -1.092548430592079 * z
        fC1 = x * x - y * y
        fS1 = 2.0 * x * y
        out += [
            0.5462742152960395 * fS1,
            fTmp0B * y,
            0.9461746957575601 * z2 - 0.3153915652525201,
            fTmp0B * x,
            0.5462742152960395 * fC1,
        ]
    if degree >= 3:
        fTmp0C = -2.285228997322329 * z2 + 0.4570457994644658
        fTmp1B = 1.445305721320277 * z
        fC2 = x * fC1 - y * fS1
        fS2 = x * fS1 + y * fC1
        out += [
            -0.5900435899266435 * fS2,
            fTmp1B * fS1,
            fTmp0C * y,
            z * (1.865881662950577 * z2 - 1.119528997770346),
            fTmp0C * x,
            fTmp1B * fC1,
            -0.5900435899266435 * fC2,
        ]
    if degree >= 4:
        pSH6 = out[6]
        pSH12 = out[12]
        fTmp0D = z * (-4.683325804901025 * z2 + 2.007139630671868)
        fTmp1C = 3.31161143515146 * z2 - 0.47308734787878
        fTmp2B = -1.770130769779931 * z
        fC3 = x * fC2 - y * fS2
        fS3 = x * fS2 + y * fC2
        out += [
            0.6258357354491763 * fS3,
            fTmp2B * fS2,
            fTmp1C * fS1,
            fTmp0D * y,
            1.984313483298443 * z * pSH12 - 1.006230589874905 * pSH6,
            fTmp0D * x,
            fTmp1C * fC1,
            fTmp2B * fC2,
            0.6258357354491763 * fC3,
        ]
    return torch.stack(out, dim=-1)


def spherical_harmonics(
    degrees_to_use: int,
    dirs: torch.Tensor,  # [..., 3]
    coeffs: torch.Tensor,  # [..., K, 3]
    masks: Optional[torch.Tensor] = None,  # [...] bool
) -> torch.Tensor:
    """SH -> RGB colors. K may exceed (degrees_to_use+1)^2; the extra
    coefficients are ignored. ``masks`` zeroes hidden Gaussians."""
    k_used = num_sh_bases(degrees_to_use)
    if coeffs.shape[-2] < k_used:
        raise ValueError(f"need {k_used} SH coefficients, got "
                         f"{coeffs.shape[-2]}")
    basis = sh_basis(degrees_to_use, dirs)
    colors = torch.einsum("...k,...kc->...c", basis, coeffs[..., :k_used, :])
    if masks is not None:
        colors = torch.where(masks[..., None], colors,
                             torch.zeros((), dtype=colors.dtype,
                                         device=colors.device))
    return colors
