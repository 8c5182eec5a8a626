"""Evaluation camera paths (port of gscodec_studio_tpu/datasets/traj.py,
numpy and scipy): through the poses (cubic splines), an ellipse around
them, and a forward-facing spiral. Each returns [N, 4, 4] OpenCV c2w.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else np.array([0.0, 0.0, 1.0])


def look_at(position, target, up=np.array([0.0, -1.0, 0.0])):
    """OpenCV-convention c2w from eye/target."""
    fwd = _normalize(target - position)
    right = _normalize(np.cross(up, fwd))
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = position
    return c2w


def generate_interpolated_path(
    camtoworlds: np.ndarray, n_interp: int = 1
) -> np.ndarray:
    """Smooth path through the given poses: cubic-interpolated positions and
    slerp-free normalized-axis interpolation of viewing frames."""
    from scipy.interpolate import CubicSpline

    n = len(camtoworlds)
    t = np.arange(n)
    tq = np.linspace(0, n - 1, n * n_interp, endpoint=False)
    pos = CubicSpline(t, camtoworlds[:, :3, 3], axis=0)(tq)
    fwd = CubicSpline(t, camtoworlds[:, :3, 2], axis=0)(tq)
    up = CubicSpline(t, -camtoworlds[:, :3, 1], axis=0)(tq)
    out = []
    for p, f, u in zip(pos, fwd, up):
        out.append(look_at(p, p + _normalize(f), _normalize(u)))
    return np.stack(out)


def generate_ellipse_path(
    camtoworlds: np.ndarray, n_frames: int = 120, variation: float = 0.0,
    height_offset: float = 0.0,
) -> np.ndarray:
    """Elliptical orbit fitted to the camera positions, looking at their
    focus."""
    pos = camtoworlds[:, :3, 3]
    center = pos.mean(axis=0)
    radii = np.percentile(np.abs(pos - center), 90, axis=0)
    # degenerate axes fall back to the overall scene radius
    overall = max(np.linalg.norm(pos - center, axis=-1).max(), 1e-6)
    radii = np.where(radii < 1e-6 * overall, overall, radii)
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    z = center[2] + radii[2] * variation * np.sin(theta)
    eye = np.stack(
        [
            center[0] + radii[0] * np.cos(theta),
            np.full_like(theta, center[1] + height_offset),
            center[2] + radii[2] * np.sin(theta),
        ],
        axis=-1,
    )
    return np.stack([look_at(e, center) for e in eye])


def generate_spiral_path(
    camtoworlds: np.ndarray, n_frames: int = 120, n_rots: int = 2,
    zrate: float = 0.5, radius_scale: float = 0.7,
) -> np.ndarray:
    """NeRF-style forward-facing spiral around the mean pose."""
    pos = camtoworlds[:, :3, 3]
    center = pos.mean(axis=0)
    radius = radius_scale * np.percentile(
        np.linalg.norm(pos - center, axis=-1), 90
    )
    mean_fwd = _normalize(camtoworlds[:, :3, 2].mean(axis=0))
    target = center + mean_fwd * radius * 2
    theta = np.linspace(0, 2 * np.pi * n_rots, n_frames)
    out = []
    for th in theta:
        eye = center + radius * np.array(
            [np.cos(th), -np.sin(th) * 0.4, -np.sin(th * zrate) * 0.2]
        )
        out.append(look_at(eye, target))
    return np.stack(out)
