"""Render splat models from a camera rig (port of
gscodec_studio_tpu/utils/ply_render.py: orbit_cameras, render_splats)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gscodec_studio_tpu_torch.models.splats import SplatModel
from gscodec_studio_tpu_torch.rendering import rasterization


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
) -> List[Tuple[torch.Tensor, torch.Tensor, Dict]]:
    """Render ``model`` for each camera on the model's device through the
    fused path; returns one (rgb [H,W,3] clipped to [0, 1], alpha [H,W,1],
    meta) per camera. Activations are exp(scales) and sigmoid(opacities),
    as the JAX package's render_splats takes them."""
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
                device=dev,
            )
            out.append((torch.clamp(img[0], 0.0, 1.0), alpha[0], meta))
    return out
