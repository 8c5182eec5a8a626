"""EWA splat projection: world-space 3D Gaussians -> per-camera 2D Gaussians
(port of gscodec_studio_tpu/ops/projection.py, pinhole path).

Conventions are the JAX package's: viewmats [C,4,4] world->cam (OpenCV,
+z forward); conics are the upper triangle (a, b, c) of the inverse 2D
covariance; radii 0 marks a culled Gaussian and its other outputs are
zeroed. With ``elliptical=True`` radii are per-axis AABB half-widths
[C,N,2], which the fused binning uses.
"""

from __future__ import annotations

from typing import Optional

import torch

CAMERA_MODELS = ("pinhole", "ortho", "fisheye")


def _covar6_from_quat_scale(quats, scales):
    """Upper-triangular covariance components (xx,xy,xz,yy,yz,zz)."""
    q = quats / torch.clamp(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12
    )
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = scales[..., 0] ** 2, scales[..., 1] ** 2, scales[..., 2] ** 2
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return xx, xy, xz, yy, yz, zz


def _rotate_covar6(R, c6):
    """R Sigma R^T for per-camera R [C,3,3] and shared Sigma components [N]
    -> camera-frame components [C,N]."""
    xx, xy, xz, yy, yz, zz = (v[None, :] for v in c6)
    r = [[R[:, i, j, None] for j in range(3)] for i in range(3)]

    def row(i):
        a = r[i][0] * xx + r[i][1] * xy + r[i][2] * xz
        b = r[i][0] * xy + r[i][1] * yy + r[i][2] * yz
        c = r[i][0] * xz + r[i][1] * yz + r[i][2] * zz
        return a, b, c

    rows = [row(i) for i in range(3)]

    def entry(i, j):
        a, b, c = rows[i]
        return a * r[j][0] + b * r[j][1] + c * r[j][2]

    return (entry(0, 0), entry(0, 1), entry(0, 2),
            entry(1, 1), entry(1, 2), entry(2, 2))


def fully_fused_projection(
    means: torch.Tensor,  # [N, 3]
    covars: Optional[torch.Tensor],  # must be None (pinhole fast path)
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    opacities: Optional[torch.Tensor] = None,  # [N] linear opacity
    elliptical: bool = False,
):
    """Fused world->2D projection with culling.

    Returns (radii [C,N] or [C,N,2] int32, means2d [C,N,2], depths [C,N],
    conics [C,N,3], compensations [C,N] or None). With ``opacities`` the
    radius is the exact alpha-threshold extent min(3, sqrt(2 ln(255 op)))
    sigmas instead of 3 sigmas."""
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    if camera_model != "pinhole":
        raise NotImplementedError(
            f"camera_model={camera_model!r} is not ported yet (pinhole only)"
        )
    if covars is not None:
        raise NotImplementedError(
            "explicit covars are not ported yet; pass quats and scales"
        )
    return _fused_projection_pinhole(
        means, quats, scales, viewmats, Ks, width, height, eps2d, near_plane,
        far_plane, radius_clip, calc_compensations, opacities, elliptical,
    )


def _fused_projection_pinhole(
    means, quats, scales, viewmats, Ks, width, height, eps2d, near_plane,
    far_plane, radius_clip, calc_compensations, opacities=None,
    elliptical=False,
):
    """The whole pinhole chain as elementwise component math."""
    R = viewmats[:, :3, :3]
    t = viewmats[:, :3, 3]
    mx, my, mz = means[:, 0][None], means[:, 1][None], means[:, 2][None]
    xc = R[:, 0, 0, None] * mx + R[:, 0, 1, None] * my + R[:, 0, 2, None] * mz + t[:, 0, None]
    yc = R[:, 1, 0, None] * mx + R[:, 1, 1, None] * my + R[:, 1, 2, None] * mz + t[:, 1, None]
    zc = R[:, 2, 0, None] * mx + R[:, 2, 1, None] * my + R[:, 2, 2, None] * mz + t[:, 2, None]
    depths = zc

    c6 = _covar6_from_quat_scale(quats, scales)
    cxx, cxy, cxz, cyy, cyz, czz = _rotate_covar6(R, c6)

    fx, fy = Ks[:, 0, 0, None], Ks[:, 1, 1, None]
    cx, cy = Ks[:, 0, 2, None], Ks[:, 1, 2, None]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    rz = 1.0 / zc
    rz2 = rz * rz
    tx = zc * torch.minimum(torch.maximum(xc * rz, -lim_x_neg), lim_x_pos)
    ty = zc * torch.minimum(torch.maximum(yc * rz, -lim_y_neg), lim_y_pos)

    # J = [[a0, 0, c0], [0, b1, c1]]
    a0 = fx * rz
    c0 = -fx * tx * rz2
    b1 = fy * rz
    c1 = -fy * ty * rz2
    cov00 = a0 * a0 * cxx + 2 * a0 * c0 * cxz + c0 * c0 * czz
    cov01 = a0 * b1 * cxy + a0 * c1 * cxz + c0 * b1 * cyz + c0 * c1 * czz
    cov11 = b1 * b1 * cyy + 2 * b1 * c1 * cyz + c1 * c1 * czz

    det_orig = cov00 * cov11 - cov01 * cov01
    cov00 = cov00 + eps2d
    cov11 = cov11 + eps2d
    det = cov00 * cov11 - cov01 * cov01
    compensations = torch.sqrt(torch.clamp(
        det_orig / torch.clamp(det, min=1e-30), min=0.0
    ))
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    conic_a = cov11 * inv_det
    conic_b = -cov01 * inv_det
    conic_c = cov00 * inv_det

    x2d = fx * xc * rz + cx
    y2d = fy * yc * rz + cy

    b = 0.5 * (cov00 + cov11)
    v1 = b + torch.sqrt(torch.clamp(b * b - det, min=0.01))
    nsig = 3.0
    if opacities is not None:
        nsig = torch.clamp(torch.clamp(
            torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * opacities,
                                                   min=1e-30))),
            max=3.0,
        ), min=0.0)[None, :]
    if elliptical:
        rx = torch.ceil(nsig * torch.sqrt(torch.clamp(cov00, min=0.0)))
        ry = torch.ceil(nsig * torch.sqrt(torch.clamp(cov11, min=0.0)))
    else:
        rx = ry = torch.ceil(nsig * torch.sqrt(v1))

    valid = (depths > near_plane) & (depths < far_plane) & (det > 0)
    valid &= torch.maximum(rx, ry) > radius_clip
    valid &= (x2d + rx > 0) & (x2d - rx < width)
    valid &= (y2d + ry > 0) & (y2d - ry < height)

    zero = torch.zeros((), dtype=depths.dtype, device=depths.device)
    if elliptical:
        radii = torch.where(
            valid[..., None], torch.stack([rx, ry], dim=-1), zero
        ).to(torch.int32)
    else:
        radii = torch.where(valid, rx, zero).to(torch.int32)
    means2d = torch.stack(
        [torch.where(valid, x2d, zero), torch.where(valid, y2d, zero)], dim=-1
    )
    conics = torch.stack(
        [torch.where(valid, conic_a, zero), torch.where(valid, conic_b, zero),
         torch.where(valid, conic_c, zero)],
        dim=-1,
    )
    depths = torch.where(valid, depths, zero)
    if calc_compensations:
        return radii, means2d, depths, conics, torch.where(
            valid, compensations, zero
        )
    return radii, means2d, depths, conics, None
