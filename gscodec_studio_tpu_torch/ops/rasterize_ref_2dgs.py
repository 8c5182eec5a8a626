"""The 2DGS oracle rasterizer in plain PyTorch (port of
gscodec_studio_tpu/ops/rasterize_ref_2dgs.py): every (pixel, surfel) pair
at once, O(C*N*H*W) memory. The reference backend of
``rendering.rasterization_2dgs`` and a test oracle; gradients by autograd.

Per pair: the ray-splat intersection by the homogeneous-plane cross
product, kernel weight min(UV-space Gaussian, 2x-filtered screen
Gaussian), then front-to-back compositing of the colours, alpha, normals,
the distortion accumulator and the median depth.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999
FILTER_INV_SQUARE = 2.0


def rasterize_to_pixels_2dgs_ref(
    means2d: torch.Tensor,  # [C, N, 2]
    ray_transforms: torch.Tensor,  # [C, N, 3, 3]
    colors: torch.Tensor,  # [C, N, ch] (the LAST channel is the depth)
    opacities: torch.Tensor,  # [C, N]
    normals: torch.Tensor,  # [C, N, 3]
    depths: torch.Tensor,  # [C, N] (sort key)
    radii: torch.Tensor,  # [C, N]
    width: int,
    height: int,
    tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,  # [C, ch]
):
    """Returns (colors [C,H,W,ch], alphas [C,H,W,1], render_normals
    [C,H,W,3], distort [C,H,W,1], median_depth [C,H,W,1])."""
    dev = means2d.device
    tw = -(-width // tile_size)
    th = -(-height // tile_size)

    key = torch.where(radii > 0, depths,
                      torch.full((), math.inf, device=dev))
    order = torch.argsort(key, dim=1, stable=True)

    def gather(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return torch.take_along_dim(x, idx, dim=1)

    C, N = order.shape
    means2d = gather(means2d)
    M = gather(ray_transforms.reshape(C, N, 9)).reshape(C, N, 3, 3)
    colors = gather(colors)
    opacities = gather(opacities)
    normals = gather(normals)
    radii = gather(radii)

    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    PX = px[None, None, None, :]  # [1,1,1,W]
    PY = py[None, None, :, None]  # [1,1,H,1]

    M0 = M[..., 0, :][..., None, None, :]  # [C,N,1,1,3]
    M1 = M[..., 1, :][..., None, None, :]
    M2 = M[..., 2, :][..., None, None, :]
    # h_u = px*M2 - M0 ; h_v = py*M2 - M1 (each [C,N,H,W,3])
    h_u = PX[..., None] * M2 - M0
    h_v = PY[..., None] * M2 - M1
    cross = torch.linalg.cross(h_u, h_v, dim=-1)
    cz = cross[..., 2]
    safe_cz = torch.where(cz == 0, torch.ones_like(cz), cz)
    s_u = cross[..., 0] / safe_cz
    s_v = cross[..., 1] / safe_cz
    gw3d = s_u * s_u + s_v * s_v
    dx = means2d[..., 0][..., None, None] - PX
    dy = means2d[..., 1][..., None, None] - PY
    gw2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    sigma = 0.5 * torch.minimum(gw3d, gw2d)
    alpha = torch.clamp(opacities[..., None, None] * torch.exp(-sigma),
                        max=MAX_ALPHA)

    # the tile-inclusion rule (the same binning as 3DGS)
    tr = radii.to(torch.float32) / tile_size
    tm = means2d / tile_size
    tminx = torch.clamp(torch.floor(tm[..., 0] - tr), 0, tw)
    tminy = torch.clamp(torch.floor(tm[..., 1] - tr), 0, th)
    tmaxx = torch.clamp(torch.ceil(tm[..., 0] + tr), 0, tw)
    tmaxy = torch.clamp(torch.ceil(tm[..., 1] + tr), 0, th)
    ptx = torch.div(torch.arange(width, device=dev), tile_size,
                    rounding_mode="floor").to(torch.float32)
    pty = torch.div(torch.arange(height, device=dev), tile_size,
                    rounding_mode="floor").to(torch.float32)
    in_x = (ptx[None, None, None, :] >= tminx[..., None, None]) & (
        ptx[None, None, None, :] < tmaxx[..., None, None])
    in_y = (pty[None, None, :, None] >= tminy[..., None, None]) & (
        pty[None, None, :, None] < tmaxy[..., None, None])
    visible = in_x & in_y & (radii > 0)[..., None, None] & (cz != 0)
    zero = torch.zeros((), device=dev)
    alpha = torch.where(
        visible & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD), alpha, zero)

    log1ma = torch.log1p(-alpha)
    logT_incl = torch.cumsum(log1ma, dim=1)
    include = logT_incl > math.log(TRANSMITTANCE_EPS)
    alpha = torch.where(include, alpha, zero)
    log1ma = torch.log1p(-alpha)
    logT_incl = torch.cumsum(log1ma, dim=1)
    logT_excl = logT_incl - log1ma
    T_prev = torch.exp(logT_excl)
    w = alpha * T_prev  # [C,N,H,W]

    out = torch.einsum("cnhw,cnk->chwk", w, colors)
    out_n = torch.einsum("cnhw,cnk->chwk", w, normals)
    alphas = w.sum(dim=1)[..., None]

    depth_ch = colors[..., -1]  # [C, N]
    wz = w * depth_ch[..., None, None]
    # distortion: 2 * sum_i (w_i z_i (1 - T_i) - w_i * sum_{j<i} w_j z_j)
    one_m_T = 1.0 - T_prev
    accum_before = torch.cumsum(wz, dim=1) - wz
    distort = (2.0 * (wz * one_m_T - w * accum_before)).sum(dim=1)[..., None]

    # median depth: the depth of the last included splat with T_prev > 0.5
    med_sel = (T_prev > 0.5) & (w > 0)
    idx = torch.arange(N, device=dev)[None, :, None, None]
    last = torch.where(med_sel, idx, torch.full_like(idx, -1)).amax(dim=1)
    z_sorted = depth_ch[..., None, None].expand(w.shape)
    med = torch.take_along_dim(z_sorted, torch.clamp(last, min=0)[:, None],
                               dim=1)[:, 0]
    med = torch.where(last >= 0, med, zero)[..., None]

    if backgrounds is not None:
        out = out + (1.0 - alphas) * backgrounds[:, None, None, :]
    return out, alphas, out_n, distort, med
