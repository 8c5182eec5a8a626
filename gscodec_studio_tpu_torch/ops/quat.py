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


def quat_scale_to_preci(quats: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Precision (inverse covariance) = R S^-2 R^T."""
    P = quat_to_rotmat(quats) / scales[..., None, :]  # R @ diag(1/s)
    return P @ P.transpose(-1, -2)


def quat_scale_to_covar_preci(quats: torch.Tensor, scales: torch.Tensor,
                              compute_covar: bool = True,
                              compute_preci: bool = True, triu: bool = False):
    """(covars, precis) from quaternion and scale; either may be None. With
    ``triu=True`` each is the upper triangle packed as [..., 6] in row-major
    order (xx, xy, xz, yy, yz, zz)."""
    covars = precis = None
    if compute_covar:
        covars = quat_scale_to_covar(quats, scales)
        if triu:
            covars = _triu_pack(covars)
    if compute_preci:
        precis = quat_scale_to_preci(quats, scales)
        if triu:
            precis = _triu_pack(precis)
    return covars, precis


def _triu_pack(mat: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 6] upper triangle (row-major)."""
    return torch.stack(
        [mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2],
         mat[..., 1, 1], mat[..., 1, 2], mat[..., 2, 2]], dim=-1)


def triu_unpack(t: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] symmetric matrix."""
    xx, xy, xz, yy, yz, zz = t.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)
