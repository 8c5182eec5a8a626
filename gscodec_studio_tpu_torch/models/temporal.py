"""Dynamic (temporal) Gaussian splats in the SpacetimeGaussian
parameterization (port of gscodec_studio_tpu/models/temporal.py).

Each splat has a temporal radial basis opacity
o(t) = o * exp(-((t - trbf_center) / (sqrt(2) * exp(trbf_scale)))^2), a
cubic polynomial motion mu(t) = mu + m1 dt + m2 dt^2 + m3 dt^3 and a linear
rotation q(t) = q + omega dt. Slicing at a time gives an ordinary static
splat dict, which the static renderer and codecs take as they are; the
colour head reads per-splat features (colour, view direction and time)
either linearly or through the Sandwich decoder, two 1x1 convolutions over
the rendered 9-channel feature map and per-pixel rays.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.models.splats import (C0, DEAD_OPACITY_LOGIT,
                                                    knn_mean_dist)


def create_dyn_splats(
    points: np.ndarray,
    rgbs: Optional[np.ndarray] = None,
    cap: Optional[int] = None,
    seed: int = 0,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The static base (means, k-NN log scales, uniform quaternions, logit
    opacities; slots past N dead) and the temporal parameters: trbf_center
    uniform in [0, 1), trbf_scale, motion [9] and omega [4] zero, and the
    colour head's features: ``colors`` the SH DC of the colours (zero past
    N), ``features_dir`` and ``features_time`` zero. Every draw is the JAX
    package's numpy draw (default_rng(seed) for the colours when none are
    given and the quaternions, default_rng(seed + 1) for the centres), so
    both packages build the same splats bit for bit."""
    dev = resolve_device(device)
    points = np.asarray(points)
    N = points.shape[0]
    cap = N if cap is None else cap
    if cap < N:
        raise ValueError(f"capacity {cap} below {N} points")
    rng = np.random.default_rng(seed)
    if rgbs is None:
        rgbs = rng.random((N, 3))
    dist = np.maximum(knn_mean_dist(points, 4), 1e-7)
    scales = np.log(dist * init_scale)[:, None].repeat(3, axis=1)

    def padded(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, dtype=np.float32)
        out[:N] = x
        return out

    logit = np.full(N, math.log(init_opacity / (1 - init_opacity)),
                    np.float32)
    quats = rng.random((cap, 4)).astype(np.float32)
    colors = np.zeros((cap, 3), np.float32)
    colors[:N] = (np.asarray(rgbs).astype(np.float32) - 0.5) / np.float32(C0)
    trbf_center = np.random.default_rng(seed + 1).random(cap).astype(
        np.float32)
    arrays = {
        "means": padded(points.astype(np.float32)),
        "scales": padded(scales.astype(np.float32), fill=-10.0),
        "quats": quats,
        "opacities": padded(logit, fill=DEAD_OPACITY_LOGIT),
        "trbf_center": trbf_center,
        "trbf_scale": np.zeros(cap, np.float32),  # exp() -> 1
        "motion": np.zeros((cap, 9), np.float32),
        "omega": np.zeros((cap, 4), np.float32),
        "colors": colors,
        "features_dir": np.zeros((cap, 3), np.float32),
        "features_time": np.zeros((cap, 3), np.float32),
    }
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def trbf(dt: torch.Tensor, trbf_scale: torch.Tensor) -> torch.Tensor:
    """The temporal radial basis exp(-(dt / (sqrt(2) exp(scale)))^2)."""
    s = torch.exp(trbf_scale)
    x = dt / (math.sqrt(2.0) * torch.clamp(s, min=1e-6))
    return torch.exp(-(x * x))


def slice_at_time(splats: Dict[str, torch.Tensor], t
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The model at time ``t`` in [0, 1]: ({means, quats, scales,
    opacities (logit)}, the trbf weight [cap]). The renderer takes linear
    opacity, so callers multiply the weight in after the sigmoid."""
    dt = t - splats["trbf_center"]
    tw = trbf(dt, splats["trbf_scale"])
    m = splats["motion"]
    dt1 = dt[:, None]
    means_t = (splats["means"] + m[:, 0:3] * dt1 + m[:, 3:6] * (dt1 * dt1)
               + m[:, 6:9] * (dt1 * dt1 * dt1))
    quats_t = splats["quats"] + splats["omega"] * dt1
    return {"means": means_t, "quats": quats_t, "scales": splats["scales"],
            "opacities": splats["opacities"]}, tw


def dyn_colors(splats: Dict[str, torch.Tensor], dirs: torch.Tensor,
               tw: torch.Tensor) -> torch.Tensor:
    """The linear colour head: base colour + direction feature * the
    normalized view direction ``dirs`` [cap, 3] + time feature * trbf."""
    d = dirs * torch.rsqrt(torch.clamp((dirs * dirs).sum(-1, keepdim=True),
                                       min=1e-12))
    return (splats["colors"] + splats["features_dir"] * d
            + splats["features_time"] * tw[:, None])


def dyn_features(splats: Dict[str, torch.Tensor],
                 dt: torch.Tensor) -> torch.Tensor:
    """The 9 feature channels the Sandwich decoder reads: colour, direction
    feature and dt * time feature, dt = t - trbf_center held constant."""
    return torch.cat([splats["colors"], splats["features_dir"],
                      dt.detach()[:, None] * splats["features_time"]], -1)


def sandwich_init(generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The Sandwich decoder's two bias-free 1x1 convolutions, 12 -> 6 -> 3,
    He-normal draws from ``generator``."""
    dev = resolve_device(device)
    return {
        "w1": torch.randn((12, 6), generator=generator, device=dev)
        * (2.0 / 12.0) ** 0.5,
        "w2": torch.randn((6, 3), generator=generator, device=dev)
        * (2.0 / 6.0) ** 0.5,
    }


def sandwich_apply(params: Dict[str, torch.Tensor], feat: torch.Tensor,
                   rays: torch.Tensor) -> torch.Tensor:
    """sigmoid(albedo + w2(relu(w1(cat(spec, time, rays))))) per pixel:
    ``feat`` [C, H, W, 9] the rendered features, ``rays`` [C, H, W, 6]."""
    albedo, spec, timef = feat[..., 0:3], feat[..., 3:6], feat[..., 6:9]
    h = torch.cat([spec, timef, rays], -1)
    h = torch.relu(torch.einsum("chwi,ij->chwj", h, params["w1"]))
    h = torch.einsum("chwi,ij->chwj", h, params["w2"])
    return torch.sigmoid(albedo + h)


def get_rays(camtoworld: torch.Tensor, K: torch.Tensor, width: int,
             height: int) -> torch.Tensor:
    """Per-pixel world-space (origin, unit direction) [H, W, 6]."""
    dev = camtoworld.device
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5
         - K[0, 2]) / K[0, 0]
    y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5
         - K[1, 2]) / K[1, 1]
    xx = x[None, :].expand(height, width)
    yy = y[:, None].expand(height, width)
    d_cam = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    d_world = torch.einsum("ij,hwj->hwi", camtoworld[:3, :3], d_cam)
    d_world = d_world / torch.clamp(
        torch.linalg.vector_norm(d_world, dim=-1, keepdim=True), min=1e-12)
    o = camtoworld[:3, 3].expand(height, width, 3)
    return torch.cat([o, d_world], -1)


def extract_frame(splats: Dict[str, torch.Tensor], t: float,
                  visibility_eps: float = 0.05) -> Dict[str, np.ndarray]:
    """Static splats of frame ``t`` for the sequence codec, on the host:
    motion and rotation baked in, the temporal opacity folded into the
    logit (clipped to [1e-7, 1 - 1e-7] in float32), and only the splats
    whose opacity at t exceeds ``visibility_eps`` (and that are not dead)
    kept. Colours go out as sh0, with no shN bands."""
    with torch.no_grad():
        dev = splats["means"].device
        params, tw = slice_at_time(
            splats, torch.tensor(t, dtype=torch.float32, device=dev))
        op_lin = (torch.sigmoid(splats["opacities"]) * tw).cpu().numpy()
        alive = (splats["opacities"] > DEAD_OPACITY_LOGIT + 1.0).cpu()
        keep = (op_lin > visibility_eps) & alive.numpy()
        op_lin = np.clip(op_lin, 1e-7, 1 - 1e-7)
        logit = np.log(op_lin / (1 - op_lin)).astype(np.float32)
        out = {
            "means": params["means"].cpu().numpy(),
            "quats": params["quats"].cpu().numpy(),
            "scales": params["scales"].cpu().numpy(),
            "opacities": logit,
            "sh0": splats["colors"].cpu().numpy().reshape(-1, 1, 3),
            "shN": np.zeros((len(logit), 0, 3), np.float32),
        }
    return {k: v[keep] for k, v in out.items()}
