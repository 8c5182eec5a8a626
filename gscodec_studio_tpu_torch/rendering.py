"""Top-level rendering API (port of gscodec_studio_tpu/rendering.py):
``rasterization()``, projection -> SH -> binning and tile rasterization,
returning (render_colors, render_alphas, meta), on the fused backend or
the legacy v1 one (``rasterizer="pallas"``) or the dense oracle;
``rasterization_2dgs()`` for surfels, with its fused and reference
backends, and ``depth_to_normal()``. Differentiable: gradients reach
means, quats, scales, opacities, colors and backgrounds through autograd
of the plain projection and SH and the rasterizers' backward kernels."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.ops import rasterize_pallas
from gscodec_studio_tpu_torch.ops.isect import (isect_offset_encode,
                                                isect_tiles)
from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
from gscodec_studio_tpu_torch.ops.projection_2dgs import (
    fully_fused_projection_2dgs)
from gscodec_studio_tpu_torch.ops.raster_v2 import (MAX_CHANNELS,
                                                    rasterize_to_pixels_v2)
from gscodec_studio_tpu_torch.ops.raster_v2_2dgs import (
    rasterize_to_pixels_2dgs_v2)
from gscodec_studio_tpu_torch.ops.rasterize_ref import (
    rasterize_to_pixels_ref)
from gscodec_studio_tpu_torch.ops.rasterize_ref_2dgs import (
    rasterize_to_pixels_2dgs_ref)
from gscodec_studio_tpu_torch.ops.sh import spherical_harmonics

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")
RASTERIZERS = ("fused", "pallas", "reference")


def _default_isect_capacity(C: int, N: int) -> int:
    """~8 tiles per Gaussian, rounded up to a multiple of 1024."""
    cap = max(C * N * 8, 1 << 16)
    return ((cap + 1023) // 1024) * 1024


def project_and_shade(means, quats, scales, opacities, colors, viewmats, Ks,
                      width: int, height: int, near_plane: float = 0.01,
                      far_plane: float = 1e10, radius_clip: float = 0.0,
                      eps2d: float = 0.3, sh_degree: Optional[int] = None,
                      antialiased: bool = False,
                      camera_model: str = "pinhole",
                      elliptical: bool = True):
    """The stages of ``rasterization`` before binning, on tensors: the
    projection and the 1/255 opacity cull, the SH colors (+0.5, clipped at
    0) and the per-camera opacities. The radii are per-axis elliptical
    ([C,N,2], the fused backend's) or, with ``elliptical=False``, the
    scalar radius ([C,N], the other backends'). Returns (radii, means2d,
    depths, conics, colors [C,N,D], opacities [C,N], compensations or
    None)."""
    C = viewmats.shape[0]
    N = means.shape[0]
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, None, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip,
        calc_compensations=antialiased,
        camera_model=camera_model, opacities=opacities,
        elliptical=elliptical,
    )
    # a splat with linear opacity < 1/255 never passes the alpha threshold
    opac_ok = opacities[None, :] >= 1.0 / 255.0
    radii = torch.where(opac_ok[..., None] if elliptical else opac_ok, radii,
                        torch.zeros_like(radii))
    radii_scalar = radii.amax(dim=-1) if elliptical else radii

    opacities_cn = opacities[None, :].expand(C, N)
    if compensations is not None:
        opacities_cn = opacities_cn * compensations

    colors_cn = _sh_colors(means, colors, viewmats, sh_degree, radii_scalar)
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
    rasterizer: str = "fused",
    cutoff_mode: str = "exact",
    grad_dtype: str = "f32",
    log_composite: bool = False,
    attr_dtype: str = "f32",
    geom_dtype: str = "f32",
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
    of |per-pixel dL/d means2d| (fused backend only).

    ``rasterizer``: "fused" (ops/raster_v2.py, binning with elliptical
    radii), "pallas" (the legacy v1 tile kernels, ops/rasterize_pallas.py,
    on ops/isect.py's binning with the scalar radius; its cutoff is that
    module's CUTOFF_MODE) or "reference" (the dense oracle,
    ops/rasterize_ref.py, on the scalar radius). The non-fused backends
    render at most min(channel_chunk, 128) channels at a time and add the
    binning's tiles_per_gauss, tile_keys, flatten_ids, tile_offsets to
    ``meta``. The fused backend's knobs, ignored by the others as in the
    JAX package: ``cutoff_mode``; ``grad_dtype`` ("f32" or "bf16"), the
    gradient-row type; ``log_composite``, the log-space transmittance
    scan; ``attr_dtype`` ("f32" or "bf16"), the sorted table's opacity,
    conic and colour rows; ``geom_dtype`` ("f32" or "u16"), its position
    rows."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"unknown rasterize_mode {rasterize_mode!r}")
    if rasterizer not in RASTERIZERS:
        raise ValueError(f"unknown rasterizer {rasterizer!r}")
    if absgrad_probe is not None and rasterizer != "fused":
        raise ValueError("absgrad accumulation requires the 'fused' "
                         "rasterizer")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    means, quats, scales, opacities = map(f32, (means, quats, scales,
                                                opacities))
    colors, viewmats, Ks = map(f32, (colors, viewmats, Ks))
    C = viewmats.shape[0]
    fused = rasterizer == "fused"
    (radii, means2d, depths, conics, colors_cn, opacities_cn,
     compensations) = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        eps2d=eps2d, sh_degree=sh_degree,
        antialiased=rasterize_mode == "antialiased",
        camera_model=camera_model, elliptical=fused,
    )
    radii_scalar = radii.amax(dim=-1) if fused else radii
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

    D = colors_cn.shape[-1]
    chunks = []
    if fused:
        # wide renders bin once per 128 channels, as the JAX package does
        step = max(channel_chunk, 128)
        for lo in range(0, D, step):
            bgs = None if backgrounds_used is None else \
                backgrounds_used[..., lo:lo + step]
            img, render_alphas, vmeta = rasterize_to_pixels_v2(
                means2d, conics, colors_cn[..., lo:lo + step],
                opacities_cn, depths, radii, width, height,
                tile_size=tile_size, isect_capacity=isect_capacity,
                backgrounds=bgs, absgrad_probe=absgrad_probe,
                cutoff_mode=cutoff_mode, grad_dtype=grad_dtype,
                attr_dtype=attr_dtype, log_composite=log_composite,
                geom_dtype=geom_dtype, device=dev,
            )
            chunks.append(img)
        meta_extra = dict(n_isects=vmeta["n_isects"])
    else:
        isect = isect_tiles(
            means2d, radii_scalar, depths, tile_size, tile_width,
            tile_height, isect_capacity,
            need_inv_perm=(rasterizer != "pallas"
                           or rasterize_pallas.SEGRED_MODE == "cumsum"))
        tile_offsets = isect_offset_encode(isect.tile_keys, C, tile_width,
                                           tile_height)
        # binned once; rendered min(channel_chunk, 128) channels at a time
        step = min(channel_chunk, MAX_CHANNELS)
        for lo in range(0, D, step):
            bgs = None if backgrounds_used is None else \
                backgrounds_used[..., lo:lo + step]
            img, render_alphas = _rasterize_backend(
                rasterizer, means2d, conics, colors_cn[..., lo:lo + step],
                opacities_cn, depths, radii_scalar, isect, tile_offsets,
                width, height, tile_size, bgs)
            chunks.append(img)
        meta_extra = dict(
            tiles_per_gauss=isect.tiles_per_gauss,
            tile_keys=isect.tile_keys, flatten_ids=isect.flatten_ids,
            tile_offsets=tile_offsets, n_isects=isect.n_isects)
    render_colors = chunks[0] if len(chunks) == 1 else torch.cat(chunks, -1)

    if render_mode in ("ED", "RGB+ED"):
        d = render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)
        render_colors = torch.cat([render_colors[..., :-1], d], dim=-1)

    meta = dict(
        radii=radii_scalar, means2d=means2d, depths=depths, conics=conics,
        opacities=opacities_cn, compensations=compensations, width=width,
        height=height, tile_width=tile_width, tile_height=tile_height,
        tile_size=tile_size, n_cameras=C, **meta_extra,
    )
    return render_colors, render_alphas, meta


def _rasterize_backend(rasterizer, means2d, conics, colors, opacities,
                       depths, radii, isect, tile_offsets, width, height,
                       tile_size, backgrounds):
    """One channel chunk through a non-fused backend."""
    if rasterizer == "reference":
        return rasterize_to_pixels_ref(means2d, conics, colors, opacities,
                                       depths, radii, width, height,
                                       tile_size, backgrounds)
    return rasterize_pallas.rasterize_to_pixels(
        means2d, conics, colors, opacities, isect, tile_offsets, width,
        height, tile_size, backgrounds)


def _sh_colors(means, colors, viewmats, sh_degree, radii_scalar):
    """Per-camera colors [C, N, D]: the colors as given (broadcast over
    the cameras) without ``sh_degree``, else the SH evaluated toward each
    camera, + 0.5 and clipped at 0."""
    C = viewmats.shape[0]
    if sh_degree is None:
        return colors[None].expand((C,) + colors.shape) \
            if colors.ndim == 2 else colors
    campos = -torch.einsum("cij,ci->cj", viewmats[:, :3, :3],
                           viewmats[:, :3, 3])
    dirs = means[None, :, :] - campos[:, None, :]
    shs = colors if colors.ndim == 4 else colors[None].expand(
        (C,) + colors.shape)
    colors_cn = spherical_harmonics(sh_degree, dirs, shs,
                                    masks=radii_scalar > 0)
    return torch.clamp(colors_cn + 0.5, min=0.0)


def project_and_shade_2dgs(means, quats, scales, opacities, colors,
                           viewmats, Ks, width: int, height: int,
                           near_plane: float = 0.01,
                           far_plane: float = 1e10, radius_clip: float = 0.0,
                           sh_degree: Optional[int] = None,
                           elliptical: bool = True):
    """The stages of ``rasterization_2dgs`` before binning, on tensors: the
    surfel projection with opacity-aware radii (per-axis [C,N,2] with
    ``elliptical``, the fused backend's, else [C,N]) and the 1/255 opacity
    cull, the SH colors with the depth appended as the last channel, and
    the per-camera opacities. Returns (radii, means2d, depths,
    ray_transforms, normals, colors [C,N,D+1], opacities [C,N])."""
    C = viewmats.shape[0]
    N = means.shape[0]
    radii, means2d, depths, ray_transforms, normals = (
        fully_fused_projection_2dgs(
            means, quats, scales, viewmats, Ks, width, height, near_plane,
            far_plane, radius_clip, opacities=opacities,
            elliptical=elliptical))
    opac_ok = opacities[None, :] >= 1.0 / 255.0
    radii = torch.where(opac_ok[..., None] if elliptical else opac_ok, radii,
                        torch.zeros_like(radii))
    radii_sc = radii.amax(dim=-1) if elliptical else radii
    colors_cn = _sh_colors(means, colors, viewmats, sh_degree, radii_sc)
    # the depth rides as the last channel, for the distortion and median
    colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
    return (radii, means2d, depths, ray_transforms, normals, colors_cn,
            opacities[None, :].expand(C, N))


def rasterization_2dgs(
    means,  # [N, 3]
    quats,  # [N, 4]
    scales,  # [N, 3] (z ignored)
    opacities,  # [N]
    colors,  # [(C,) N, D] or SH [(C,) N, K, 3]
    viewmats,  # [C, 4, 4]
    Ks,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds=None,  # [C, D + 1]: the colors and the depth channel
    render_mode: str = "RGB",
    depth_mode: str = "expected",
    rasterizer: str = "auto",
    isect_capacity: Optional[int] = None,
    log_composite: bool = False,
    device: DeviceLike = None,
):
    """2DGS (surfel) rendering. Returns (render_colors, render_alphas,
    render_normals, surf_normals, render_distort, render_median, meta).

    Backends: ``"fused"``, the 2DGS tile kernels on raster_v2's binning
    and reduction (ops/raster_v2_2dgs.py); ``"reference"``, the plain
    O(C*N*H*W) oracle (ops/rasterize_ref_2dgs.py); ``"auto"``, fused on a
    CUDA device and the reference on the CPU. The distortion is always
    rendered (the JAX signature's unused ``distloss`` is not taken);
    ``depth_mode`` "median" takes the surface normals from the median
    depth; ``log_composite`` reaches the fused backend only, as in JAX."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"unknown render_mode {render_mode!r}")
    if depth_mode not in ("expected", "median"):
        raise ValueError(f"unknown depth_mode {depth_mode!r}")
    dev = resolve_device(device)
    if rasterizer == "auto":
        rasterizer = "fused" if dev.type == "cuda" else "reference"
    if rasterizer not in ("fused", "reference"):
        raise ValueError(f"unknown rasterizer {rasterizer!r}")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    means, quats, scales, opacities = map(f32, (means, quats, scales,
                                                opacities))
    colors, viewmats, Ks = map(f32, (colors, viewmats, Ks))
    C = viewmats.shape[0]
    N = means.shape[0]
    (radii, means2d, depths, ray_transforms, normals, colors_cn,
     opacities_cn) = project_and_shade_2dgs(
        means, quats, scales, opacities, colors, viewmats, Ks, width,
        height, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip, sh_degree=sh_degree,
        elliptical=rasterizer == "fused")
    radii_sc = radii.amax(dim=-1) if radii.ndim == 3 else radii

    if rasterizer == "fused":
        cap = isect_capacity or _default_isect_capacity(C, N)
        (render, alphas, render_normals, render_distort, render_median,
         kmeta) = rasterize_to_pixels_2dgs_v2(
            means2d, ray_transforms, colors_cn, opacities_cn, normals,
            depths, radii, width, height, tile_size=tile_size,
            isect_capacity=cap, backgrounds=backgrounds,
            log_composite=log_composite, device=dev)
        n_isects = kmeta["n_isects"]
    else:
        n_isects = torch.zeros((), dtype=torch.int32, device=dev)
        render, alphas, render_normals, render_distort, render_median = (
            rasterize_to_pixels_2dgs_ref(
                means2d, ray_transforms, colors_cn, opacities_cn, normals,
                depths, radii_sc, width, height, tile_size,
                None if backgrounds is None else f32(backgrounds)))
    render_colors, accum_depth = render[..., :-1], render[..., -1:]
    if render_mode in ("ED", "RGB+ED"):
        accum_depth = accum_depth / torch.clamp(alphas, min=1e-10)
    depth_out = render_median if depth_mode == "median" else accum_depth
    surf_normals = depth_to_normal(depth_out, viewmats, Ks)

    meta = dict(
        radii=radii_sc, means2d=means2d, depths=depths,
        ray_transforms=ray_transforms, normals=normals, width=width,
        height=height, n_cameras=C, gradient_2dgs=means2d,
        n_isects=n_isects,
    )
    if render_mode in ("RGB+D", "RGB+ED"):
        render_colors = torch.cat([render_colors, depth_out], dim=-1)
    elif render_mode in ("D", "ED"):
        render_colors = depth_out
    return (render_colors, alphas, render_normals, surf_normals,
            render_distort, render_median, meta)


def depth_to_normal(depths, viewmats, Ks):
    """Per-pixel camera-frame normals [C, H, W, 3] from central
    differences of the un-projected depth map [C, H, W, 1]; the one-pixel
    border is zero."""
    C, H, W, _ = depths.shape
    fx = Ks[:, 0, 0][:, None, None]
    fy = Ks[:, 1, 1][:, None, None]
    cx = Ks[:, 0, 2][:, None, None]
    cy = Ks[:, 1, 2][:, None, None]
    xs = torch.arange(W, dtype=depths.dtype,
                      device=depths.device)[None, None, :] + 0.5
    ys = torch.arange(H, dtype=depths.dtype,
                      device=depths.device)[None, :, None] + 0.5
    z = depths[..., 0]
    X = (xs - cx) / fx * z
    Y = (ys - cy) / fy * z
    pts = torch.stack([X, Y, z], dim=-1)  # [C, H, W, 3]
    dx = pts[:, 1:-1, 2:] - pts[:, 1:-1, :-2]
    dy = pts[:, 2:, 1:-1] - pts[:, :-2, 1:-1]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # rsqrt of the clamped squared norm: finite gradients at n == 0, where
    # a bare norm's NaN gradient would poison the whole backward pass
    n = n * torch.rsqrt(torch.clamp((n * n).sum(-1, keepdim=True),
                                    min=1e-12))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
