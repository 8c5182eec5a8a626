"""Quaternion / covariance math (port of gscodec_studio_tpu/ops/quat.py).

Quaternion convention: (w, x, y, z), not necessarily normalized on input.
All functions are batched over leading dims and differentiable by autograd.
"""

from __future__ import annotations

import torch


def normalize_quat(quats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    return quats / torch.clamp(norm, min=eps)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternions -> [..., 3, 3] rotation matrices."""
    q = normalize_quat(quats)
    w, x, y, z = q.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2),
        ],
        dim=-1,
    )
    return rot.reshape(quats.shape[:-1] + (3, 3))


def quat_scale_to_covar(quats: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T.  quats [..., 4], scales [..., 3] -> [..., 3, 3]."""
    M = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(s)
    return M @ M.transpose(-1, -2)
