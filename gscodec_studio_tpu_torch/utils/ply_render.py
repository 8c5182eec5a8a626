"""Render splat models from a camera rig and score decoded frames (port of
gscodec_studio_tpu/utils/ply_render.py: orbit_cameras, render_splats,
sequence_metrics)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gscodec_studio_tpu_torch.device import DeviceLike
from gscodec_studio_tpu_torch.models.splats import SplatModel, from_jax_splats
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.utils.gsc_metrics import gsc_metrics


def orbit_cameras(
    points: np.ndarray,
    n_views: int = 4,
    width: int = 640,
    height: int = 480,
    fov_scale: float = 0.9,
    elevation: float = 0.15,
    radius_scale: float = 2.2,
):
    """Deterministic orbit rig around the cloud centroid."""
    target = np.median(points, axis=0)
    spread = float(np.linalg.norm(points - target, axis=1).mean())
    radius = radius_scale * max(spread, 1e-3)
    f = fov_scale * width
    K = np.array(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
    )
    cams = []
    for i in range(n_views):
        phi = 2.0 * np.pi * i / n_views
        eye = target + radius * np.array(
            [np.cos(phi), elevation, np.sin(phi)], np.float32
        )
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0, -1, 0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, eye
        cams.append({"camtoworld": c2w, "K": K,
                     "width": width, "height": height})
    return cams


def render_splats(
    model: SplatModel,
    cameras: Sequence[Dict],
    sh_degree: Optional[int] = None,
    isect_capacity: int = 1 << 20,
    rasterizer: str = "auto",
) -> List[Tuple[torch.Tensor, torch.Tensor, Dict]]:
    """Render ``model`` for each camera on the model's device; returns one
    (rgb [H,W,3] clipped to [0, 1], alpha [H,W,1], meta) per camera.
    Activations are exp(scales) and sigmoid(opacities), as the JAX
    package's render_splats takes them. ``rasterizer`` is rendering's:
    "fused", "pallas" or "reference"; "auto" picks the accelerator's own
    backend, which for the port's card is "fused" (the JAX package picks
    "fused" on a TPU and "pallas" elsewhere)."""
    if rasterizer == "auto":
        rasterizer = "fused"
    dev = model.means.device
    if sh_degree is None:
        sh_degree = model.sh_degree
    with torch.no_grad():
        colors = model.sh_coeffs()
        scales = torch.exp(model.scales)
        opac = torch.sigmoid(model.opacities)
        out = []
        for cam in cameras:
            vm = np.linalg.inv(np.asarray(cam["camtoworld"], np.float32))
            K = np.asarray(cam["K"], np.float32)
            img, alpha, meta = rasterization(
                model.means, model.quats, scales, opac, colors, vm[None],
                K[None], int(cam["width"]), int(cam["height"]),
                sh_degree=sh_degree, isect_capacity=isect_capacity,
                rasterizer=rasterizer, device=dev,
            )
            out.append((torch.clamp(img[0], 0.0, 1.0), alpha[0], meta))
    return out


def sequence_metrics(
    ref_frames: Sequence[Dict[str, np.ndarray]],
    dec_frames: Sequence[Dict[str, np.ndarray]],
    cameras: Sequence[Dict],
    device: DeviceLike = None,
    **render_kw,
) -> Dict[str, float]:
    """Render each frame's source and decoded splat dicts (log scales,
    logit opacities, sh0/shN) from ``cameras`` on ``device`` (None means
    the CUDA card) and average gsc_metrics over (frame, view): the
    decoded-against-source distortion the MPEG anchor scripts report.
    ``render_kw`` goes to render_splats."""
    acc: Dict[str, list] = {}
    for ref, dec in zip(ref_frames, dec_frames):
        r_imgs = render_splats(from_jax_splats(ref, device), cameras,
                               **render_kw)
        d_imgs = render_splats(from_jax_splats(dec, device), cameras,
                               **render_kw)
        for (r, _, _), (d, _, _) in zip(r_imgs, d_imgs):
            m = gsc_metrics(r.cpu().numpy(), d.cpu().numpy(), device=r.device)
            for k, v in m.items():
                acc.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in acc.items()}
