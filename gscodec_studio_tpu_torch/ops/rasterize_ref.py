"""Dense oracle rasterizer in plain PyTorch (port of
gscodec_studio_tpu/ops/rasterize_ref.py).

Materializes the full [C, N, H, W] alpha tensor, so it is for small scenes
only; it is the port's own check of the tile rasterizer where running the
JAX package is too slow. Semantics:

  * a Gaussian reaches a pixel only if the pixel's tile lies inside the
    Gaussian's [tile_min, tile_max) bounding box (the binning rule);
  * sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy; sigma < 0 is skipped;
    alpha = min(0.999, opac * exp(-sigma)); alpha < 1/255 is skipped;
  * front-to-back compositing in depth order: Gaussian k is included iff
    the inclusive transmittance product after k stays > 1e-4.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999


def rasterize_to_pixels_ref(
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, ch]
    opacities: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] or [C, N, 2] int32 (0 = culled)
    width: int,
    height: int,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, ch]
    masks: Optional[torch.Tensor] = None,  # [C, TH, TW] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (render_colors [C,H,W,ch], render_alphas [C,H,W,1])."""
    dt, dev = means2d.dtype, means2d.device
    tile_width = -(-width // tile_size)
    tile_height = -(-height // tile_size)

    ell = radii.ndim == means2d.ndim
    alive0 = (torch.maximum(radii[..., 0], radii[..., 1]) if ell
              else radii) > 0
    order = torch.argsort(
        torch.where(alive0, depths, torch.full_like(depths, math.inf)),
        dim=1, stable=True,
    )

    def gather(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return torch.take_along_dim(x, idx, dim=1)

    means2d, conics, colors = gather(means2d), gather(conics), gather(colors)
    opacities, radii = gather(opacities), gather(radii)

    px = torch.arange(width, dtype=dt, device=dev) + 0.5
    py = torch.arange(height, dtype=dt, device=dev) + 0.5
    dx = px[None, None, None, :] - means2d[..., 0][..., None, None]
    dy = py[None, None, :, None] - means2d[..., 1][..., None, None]
    a = conics[..., 0][..., None, None]
    b = conics[..., 1][..., None, None]
    c = conics[..., 2][..., None, None]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opacities[..., None, None] * torch.exp(-sigma),
                        max=MAX_ALPHA)

    if ell:
        trx = radii[..., 0].to(dt) / tile_size
        try_ = radii[..., 1].to(dt) / tile_size
        alive = torch.maximum(radii[..., 0], radii[..., 1]) > 0
    else:
        trx = try_ = radii.to(dt) / tile_size
        alive = radii > 0
    tm = means2d / tile_size
    tile_min_x = torch.clamp(torch.floor(tm[..., 0] - trx), 0, tile_width)
    tile_min_y = torch.clamp(torch.floor(tm[..., 1] - try_), 0, tile_height)
    tile_max_x = torch.clamp(torch.ceil(tm[..., 0] + trx), 0, tile_width)
    tile_max_y = torch.clamp(torch.ceil(tm[..., 1] + try_), 0, tile_height)
    ptx = (torch.arange(width, device=dev) // tile_size).to(dt)
    pty = (torch.arange(height, device=dev) // tile_size).to(dt)
    in_x = (ptx[None, None, None, :] >= tile_min_x[..., None, None]) & (
        ptx[None, None, None, :] < tile_max_x[..., None, None]
    )
    in_y = (pty[None, None, :, None] >= tile_min_y[..., None, None]) & (
        pty[None, None, :, None] < tile_max_y[..., None, None]
    )
    visible = in_x & in_y & alive[..., None, None]
    if masks is not None:
        pix_mask = masks.repeat_interleave(tile_size, dim=1).repeat_interleave(
            tile_size, dim=2
        )[:, :height, :width]
        visible &= pix_mask[:, None]

    zero = torch.zeros((), dtype=dt, device=dev)
    alpha = torch.where(
        visible & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD), alpha, zero
    )
    log1ma = torch.log1p(-alpha)
    include = torch.cumsum(log1ma, dim=1) > math.log(TRANSMITTANCE_EPS)
    alpha = torch.where(include, alpha, zero)
    log1ma = torch.log1p(-alpha)
    weights = alpha * torch.exp(torch.cumsum(log1ma, dim=1) - log1ma)

    render = torch.einsum("cnhw,cnk->chwk", weights, colors)
    alphas = weights.sum(dim=1)[..., None]
    if backgrounds is not None:
        render = render + (1.0 - alphas) * backgrounds[:, None, None, :]
    return render, alphas
