"""Top-level rendering API: ``rasterization()`` on the fused path (port of
gscodec_studio_tpu/rendering.py): projection -> SH -> fused binning and
tile rasterization, returning (render_colors, render_alphas, meta).
Differentiable: gradients reach means, quats, scales, opacities, colors
and backgrounds through autograd of the plain projection and SH and the
rasterizer's backward kernels."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
from gscodec_studio_tpu_torch.ops.raster_v2 import rasterize_to_pixels_v2
from gscodec_studio_tpu_torch.ops.sh import spherical_harmonics

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


def _default_isect_capacity(C: int, N: int) -> int:
    """~8 tiles per Gaussian, rounded up to a multiple of 1024."""
    cap = max(C * N * 8, 1 << 16)
    return ((cap + 1023) // 1024) * 1024


def project_and_shade(means, quats, scales, opacities, colors, viewmats, Ks,
                      width: int, height: int, near_plane: float = 0.01,
                      far_plane: float = 1e10, radius_clip: float = 0.0,
                      eps2d: float = 0.3, sh_degree: Optional[int] = None,
                      antialiased: bool = False,
                      camera_model: str = "pinhole"):
    """The stages of ``rasterization`` before binning, on tensors: the
    projection with elliptical radii and the 1/255 opacity cull, the SH
    colors (+0.5, clipped at 0) and the per-camera opacities. Returns
    (radii [C,N,2], means2d, depths, conics, colors [C,N,D], opacities
    [C,N], compensations or None)."""
    C = viewmats.shape[0]
    N = means.shape[0]
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, None, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip,
        calc_compensations=antialiased,
        camera_model=camera_model, opacities=opacities, elliptical=True,
    )
    # a splat with linear opacity < 1/255 never passes the alpha threshold
    opac_ok = opacities[None, :, None] >= 1.0 / 255.0
    radii = torch.where(opac_ok, radii, torch.zeros_like(radii))
    radii_scalar = radii.amax(dim=-1)

    opacities_cn = opacities[None, :].expand(C, N)
    if compensations is not None:
        opacities_cn = opacities_cn * compensations

    if sh_degree is None:
        colors_cn = colors[None].expand((C,) + colors.shape) \
            if colors.ndim == 2 else colors
    else:
        campos = -torch.einsum("cij,ci->cj", viewmats[:, :3, :3],
                               viewmats[:, :3, 3])
        dirs = means[None, :, :] - campos[:, None, :]
        shs = colors if colors.ndim == 4 else colors[None].expand(
            (C,) + colors.shape)
        colors_cn = spherical_harmonics(sh_degree, dirs, shs,
                                        masks=radii_scalar > 0)
        colors_cn = torch.clamp(colors_cn + 0.5, min=0.0)

    return (radii, means2d, depths, conics, colors_cn, opacities_cn,
            compensations)


def rasterization(
    means,  # [N, 3]
    quats,  # [N, 4]
    scales,  # [N, 3] linear
    opacities,  # [N] linear
    colors,  # [(C,) N, D] or [(C,) N, K, 3] SH coefficients
    viewmats,  # [C, 4, 4]
    Ks,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds=None,  # [C, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",  # or "antialiased"
    camera_model: str = "pinhole",
    isect_capacity: Optional[int] = None,
    channel_chunk: int = 32,
    cutoff_mode: str = "exact",
    means2d_probe=None,  # [C, N, 2] zeros
    absgrad_probe=None,  # [C, N, 2] zeros
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Differentiable batched splat rendering.

    Returns (render_colors [C,H,W,X], render_alphas [C,H,W,1], meta). X
    follows ``render_mode``: RGB -> D, D/ED -> 1, RGB+D/RGB+ED -> D+1.
    Inputs may be arrays or tensors; they are moved to ``device`` (None
    means the CUDA card). ``means2d_probe`` is added to the projected
    centers, so its gradient is dL/d means2d, the signal the densification
    strategies read; ``absgrad_probe``'s gradient is the per-Gaussian sum
    of |per-pixel dL/d means2d|."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"unknown rasterize_mode {rasterize_mode!r}")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    means, quats, scales, opacities = map(f32, (means, quats, scales,
                                                opacities))
    colors, viewmats, Ks = map(f32, (colors, viewmats, Ks))
    C = viewmats.shape[0]
    (radii, means2d, depths, conics, colors_cn, opacities_cn,
     compensations) = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        eps2d=eps2d, sh_degree=sh_degree,
        antialiased=rasterize_mode == "antialiased",
        camera_model=camera_model,
    )
    radii_scalar = radii.amax(dim=-1)
    if means2d_probe is not None:
        means2d = means2d + means2d_probe

    if render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        backgrounds_used = None
    elif render_mode in ("RGB+D", "RGB+ED"):
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        backgrounds_used = None if backgrounds is None else torch.cat(
            [f32(backgrounds), torch.zeros((C, 1), device=dev)], dim=-1)
    else:
        backgrounds_used = None if backgrounds is None else f32(backgrounds)

    tile_width = -(-width // tile_size)
    tile_height = -(-height // tile_size)
    if isect_capacity is None:
        isect_capacity = _default_isect_capacity(C, means.shape[0])

    # wide renders bin once per 128 channels, as the JAX package does
    D = colors_cn.shape[-1]
    fused_chunk = max(channel_chunk, 128)
    chunks = []
    for lo in range(0, D, fused_chunk):
        bgs = None if backgrounds_used is None else \
            backgrounds_used[..., lo:lo + fused_chunk]
        img, render_alphas, vmeta = rasterize_to_pixels_v2(
            means2d, conics, colors_cn[..., lo:lo + fused_chunk],
            opacities_cn, depths, radii, width, height, tile_size=tile_size,
            isect_capacity=isect_capacity, backgrounds=bgs,
            absgrad_probe=absgrad_probe, cutoff_mode=cutoff_mode, device=dev,
        )
        chunks.append(img)
    render_colors = chunks[0] if len(chunks) == 1 else torch.cat(chunks, -1)

    if render_mode in ("ED", "RGB+ED"):
        d = render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)
        render_colors = torch.cat([render_colors[..., :-1], d], dim=-1)

    meta = dict(
        radii=radii_scalar, means2d=means2d, depths=depths, conics=conics,
        opacities=opacities_cn, compensations=compensations, width=width,
        height=height, tile_width=tile_width, tile_height=tile_height,
        tile_size=tile_size, n_cameras=C, n_isects=vmeta["n_isects"],
    )
    return render_colors, render_alphas, meta
