"""World normalisation (port of gscodec_studio_tpu/datasets/normalize.py,
numpy in float64): a similarity from the cameras (their mean up-axis
rotated onto (0, -1, 0), the centre at the median of each view ray's point
nearest the origin, the median camera distance scaled to 1), then the
point cloud's principal axes aligned with xyz. OpenCV c2w conventions
(y- is camera-up).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Smallest rotation taking unit vector a to unit vector b (Rodrigues)."""
    v = np.cross(a, b)
    c = float(a @ b)
    if c <= -1.0 + 1e-8:  # antiparallel: rotate pi about any orthogonal axis
        return np.diag([-1.0, 1.0, -1.0])
    vx = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def similarity_from_cameras(
    c2w: np.ndarray, strict_scaling: bool = False, center_method: str = "focus"
) -> np.ndarray:
    """4x4 similarity transform normalizing OpenCV c2w cameras."""
    R = c2w[:, :3, :3]
    t = c2w[:, :3, 3]

    # World-space up = mean of camera up axes (-y rows of R).
    cam_up = np.array([0.0, -1.0, 0.0])
    world_up = (R * cam_up).sum(axis=-1).mean(axis=0)
    world_up /= np.linalg.norm(world_up)
    R_align = _rotation_between(world_up, cam_up)

    R_rot = R_align @ R
    t_rot = t @ R_align.T

    if center_method == "focus":
        fwd = (R_rot * np.array([0.0, 0.0, 1.0])).sum(axis=-1)  # view dirs
        # closest point to origin along each center ray
        nearest = t_rot + ((fwd * -t_rot).sum(-1))[:, None] * fwd
        center = np.median(nearest, axis=0)
    elif center_method == "poses":
        center = np.median(t_rot, axis=0)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    transform = np.eye(4)
    transform[:3, :3] = R_align
    transform[:3, 3] = -center

    dists = np.linalg.norm(t_rot - center, axis=-1)
    scale = 1.0 / (np.max(dists) if strict_scaling else np.median(dists))
    transform[:3, :] *= scale
    return transform


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """Rotate so the point cloud's principal axes align with xyz (smallest
    variance -> z), centered on the median."""
    center = np.median(points, axis=0)
    cov = np.cov(points - center, rowvar=False)
    eigval, eigvec = np.linalg.eigh(cov)
    order = eigval.argsort()[::-1]
    eigvec = eigvec[:, order]
    if np.linalg.det(eigvec) < 0:
        eigvec[:, 0] = -eigvec[:, 0]
    Rm = eigvec.T
    transform = np.eye(4)
    transform[:3, :3] = Rm
    transform[:3, 3] = -Rm @ center
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Apply a (possibly scaled) similarity to c2w matrices, renormalizing
    the rotation part."""
    out = np.einsum("ij,njk->nik", matrix, c2w)
    scaling = np.linalg.norm(out[:, :3, 0], axis=-1)
    out[:, :3, :3] /= scaling[:, None, None]
    return out


def normalize_world(
    camtoworlds: np.ndarray, points: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Full normalization (normalize.py ``normalize``): returns
    (camtoworlds', points', total_transform)."""
    T1 = similarity_from_cameras(camtoworlds)
    camtoworlds = transform_cameras(T1, camtoworlds)
    if points is None:
        return camtoworlds, None, T1
    points = transform_points(T1, points)
    T2 = align_principal_axes(points)
    return (
        transform_cameras(T2, camtoworlds),
        transform_points(T2, points),
        T2 @ T1,
    )
