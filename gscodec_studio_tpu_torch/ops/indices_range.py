"""Iterative index rasterization, ``rasterize_to_indices_in_range`` (port
of gscodec_studio_tpu/ops/indices_range.py).

Lists the (gaussian, pixel, camera) intersections that contribute (alpha
>= 1/255 and transmittance > 1e-4) for the depth batch ``[range_start,
range_end)`` of each camera's global depth order, continuing from
per-pixel incoming transmittances. The output has a fixed
``out_capacity`` (the valid prefix's length is returned beside it, and
entries past it are -1); the updated transmittances are returned too.

Plain PyTorch over a dense [C, R, H, W] block: it is a test and
debugging tool, meant for small batches.
"""

from __future__ import annotations

from typing import Tuple

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999


def rasterize_to_indices_in_range(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [C, H, W] current per-pixel T
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N] (global sort keys)
    radii: torch.Tensor,  # [C, N]
    width: int,
    height: int,
    tile_size: int = 16,
    out_capacity: int = 1 << 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Returns (gaussian_ids [M], pixel_ids [M], camera_ids [M], n_valid,
    new_transmittances [C, H, W]); entries beyond n_valid are -1."""
    dev = means2d.device
    R = range_end - range_start
    inf = torch.tensor(float("inf"), dtype=depths.dtype, device=dev)
    order = torch.argsort(torch.where(radii > 0, depths, inf), dim=1,
                          stable=True)
    sel = order[:, range_start:range_end]  # [C, R] original ids

    def take(x):
        idx = sel.reshape(sel.shape + (1,) * (x.ndim - 2))
        return torch.take_along_dim(x, idx, dim=1)

    m2d, con, op, rad = (take(x) for x in (means2d, conics, opacities,
                                            radii))
    px = torch.arange(width, dtype=torch.float32,
                      device=dev)[None, None, None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32,
                      device=dev)[None, None, :, None] + 0.5
    dx = m2d[..., 0][..., None, None] - px  # [C, R, H, W]
    dy = m2d[..., 1][..., None, None] - py
    ca = con[..., 0][..., None, None]
    cb = con[..., 1][..., None, None]
    cc = con[..., 2][..., None, None]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.clamp(op[..., None, None] * torch.exp(-sigma),
                        max=MAX_ALPHA)

    # the pipeline's tile-inclusion rule
    tw, th = -(-width // tile_size), -(-height // tile_size)
    tr = rad.to(torch.float32) / tile_size
    tm = m2d / tile_size
    tminx = torch.clamp(torch.floor(tm[..., 0] - tr), 0, tw)[..., None, None]
    tminy = torch.clamp(torch.floor(tm[..., 1] - tr), 0, th)[..., None, None]
    tmaxx = torch.clamp(torch.ceil(tm[..., 0] + tr), 0, tw)[..., None, None]
    tmaxy = torch.clamp(torch.ceil(tm[..., 1] + tr), 0, th)[..., None, None]
    ptx = (torch.arange(width, device=dev) // tile_size).to(torch.float32)
    pty = (torch.arange(height, device=dev) // tile_size).to(torch.float32)
    in_tile = ((ptx[None, None, None, :] >= tminx)
               & (ptx[None, None, None, :] < tmaxx)
               & (pty[None, None, :, None] >= tminy)
               & (pty[None, None, :, None] < tmaxy)
               & (rad > 0)[..., None, None])
    zero = torch.zeros((), dtype=alpha.dtype, device=dev)
    alpha = torch.where(in_tile & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD),
                        alpha, zero)

    # continue compositing from the incoming transmittances
    logT_in = torch.log(torch.clamp(transmittances, min=1e-12))[:, None]
    logT_incl = torch.cumsum(torch.log1p(-alpha), dim=1) + logT_in
    alpha = torch.where(logT_incl > torch.log(torch.tensor(
        TRANSMITTANCE_EPS, dtype=torch.float32)).to(dev), alpha, zero)
    logT_incl = torch.cumsum(torch.log1p(-alpha), dim=1) + logT_in
    new_T = torch.exp(logT_incl[:, -1]) if R > 0 else transmittances

    # static-shape compaction: the contributing flat indices first, in
    # order, then the rest; the first out_capacity kept
    flat = (alpha > 0.0).reshape(-1)
    order2 = torch.argsort((~flat).to(torch.int32), stable=True)
    order2 = order2[:out_capacity]
    valid = flat[order2]
    n_valid = flat.sum().to(torch.int32)

    HW = height * width
    cam_ids = order2 // (R * HW)
    rank = (order2 % (R * HW)) // HW
    pixel_ids = order2 % HW
    gauss_ids = sel[cam_ids, rank]
    neg = torch.full_like(order2, -1)
    return (torch.where(valid, gauss_ids, neg),
            torch.where(valid, pixel_ids, neg),
            torch.where(valid, cam_ids, neg),
            torch.clamp(n_valid, max=out_capacity), new_T)
