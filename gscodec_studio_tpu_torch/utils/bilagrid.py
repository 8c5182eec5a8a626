"""Learnable bilateral grid for per-image colour correction (port of
gscodec_studio_tpu/utils/bilagrid.py): per image a [D, H, W, 12] grid of
3x4 affine colour transforms, sampled trilinearly at each pixel's (x, y)
and its luma, and a total-variation regulariser.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def bilagrid_init(n_images: int, D: int = 8, H: int = 16, W: int = 16,
                  device=None) -> torch.Tensor:
    """Identity transforms: [n, D, H, W, 12]."""
    ident = torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                         dtype=torch.float32, device=device)
    return ident.repeat(n_images, D, H, W, 1)


def jnp_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip, as max then min: at a bound the gradient splits in half,
    as JAX's does (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


@functools.lru_cache(maxsize=16)
def _interp_matrix(n_out: int, n_in: int,
                   device: torch.device) -> torch.Tensor:
    """[n_out, n_in]: linear interpolation of n_in samples at n_out points
    spread evenly over them, each point's two weights at its cell's
    corners (the last cell's for the last point). Kept per shape and
    device, so that a training step copies nothing from the host."""
    c = torch.as_tensor(np.linspace(0.0, n_in - 1.0, n_out).astype(
        np.float32), device=device)
    i0 = torch.clamp(torch.floor(c).long(), 0, n_in - 2)
    f = c - i0
    rows = torch.arange(n_out, device=device)
    m = torch.zeros((n_out, n_in), device=device)
    m[rows, i0] = 1 - f
    m[rows, i0 + 1] = f
    return m


def bilagrid_slice(grids: torch.Tensor,  # [n, D, H, W, 12]
                   image_ids: torch.Tensor,  # [B]
                   rgb: torch.Tensor,  # [B, h, w, 3] in [0, 1]
                   ) -> torch.Tensor:
    """Each image's per-pixel affine transform, sampled trilinearly from
    its grid at (x, y, luma), applied to its colours: [B, h, w, 3].

    The (x, y) interpolation does not depend on the pixels: each depth
    slice of the grid is resampled to h x w by two interpolation matrices
    (matmuls), and each pixel then takes its two slices around its luma
    (a gather along the depth, whose backward is a scatter without
    contention). The same trilinear weights as the JAX package's eight
    corner gathers, summed in another order."""
    g = grids[image_ids]  # [B, D, H, W, 12]
    B, D, H, W, _ = g.shape
    h, w = rgb.shape[1:3]
    dev = rgb.device
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    z = jnp_clip(luma * (D - 1), 0.0, D - 1.0)  # [B, h, w]
    z0 = torch.clamp(torch.floor(z).long(), 0, D - 2)
    fz = (z - z0)[:, None]  # [B, 1, h, w]
    slices = (_interp_matrix(h, H, dev)
              @ g.permute(0, 1, 4, 2, 3)  # [B, D, 12, H, W]
              @ _interp_matrix(w, W, dev).T)  # [B, D, 12, h, w]
    idx = z0[:, None, None].expand(B, 1, 12, h, w)
    lo = slices.gather(1, idx)[:, 0]  # [B, 12, h, w]
    hi = slices.gather(1, idx + 1)[:, 0]
    aff = ((1 - fz) * lo + fz * hi).reshape(B, 3, 4, h, w)
    x = rgb.permute(0, 3, 1, 2)  # [B, 3, h, w]
    out = (aff[:, :, 0] * x[:, None, 0] + aff[:, :, 1] * x[:, None, 1]
           + aff[:, :, 2] * x[:, None, 2]) + aff[:, :, 3]
    return out.permute(0, 2, 3, 1)


def bilagrid_tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation: the mean squared difference along D, H and W,
    summed."""
    tv = 0.0
    for axis in (1, 2, 3):
        d = torch.diff(grids, dim=axis)
        tv = tv + (d * d).mean()
    return tv
