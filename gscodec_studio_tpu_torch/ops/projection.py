"""EWA splat projection: world-space 3D Gaussians -> per-camera 2D Gaussians
(port of gscodec_studio_tpu/ops/projection.py).

Conventions are the JAX package's: viewmats [C,4,4] world->cam (OpenCV,
+z forward); conics are the upper triangle (a, b, c) of the inverse 2D
covariance; radii 0 marks a culled Gaussian and its other outputs are
zeroed. With ``elliptical=True`` radii are per-axis AABB half-widths
[C,N,2], which the fused binning uses.

Routing is the JAX package's: pinhole without explicit covariances takes
the component-wise fast path; every other case (explicit ``covars``, or
the ortho or fisheye camera) takes the general branch, which forms the
camera-frame 3x3 covariances and projects them through ``proj``. The two
round differently, so a pinhole scene with covariances is not sent to the
fast path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gscodec_studio_tpu_torch.ops.quat import quat_scale_to_covar
from gscodec_studio_tpu_torch.ops.transforms import (covar_world_to_cam,
                                                     pos_world_to_cam)

CAMERA_MODELS = ("pinhole", "ortho", "fisheye")


def _sandwich(J: torch.Tensor, covars: torch.Tensor) -> torch.Tensor:
    """J Sigma J^T over leading dims: [..., 2, 3] and [..., 3, 3]."""
    return torch.einsum("...ij,...jk,...lk->...il", J, covars, J)


def persp_proj(means: torch.Tensor, covars: torch.Tensor, Ks: torch.Tensor,
               width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective EWA projection of camera-space means [..., 3] and
    covars [..., 3, 3]: (means2d [..., 2], covars2d [..., 2, 2]). The
    Jacobian is taken at a frustum-clamped point."""
    x, y, z = means.unbind(-1)
    fx, fy = Ks[..., 0, 0], Ks[..., 1, 1]
    cx, cy = Ks[..., 0, 2], Ks[..., 1, 2]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy

    rz = 1.0 / z
    rz2 = rz * rz
    tx = z * torch.minimum(torch.maximum(x * rz, -lim_x_neg), lim_x_pos)
    ty = z * torch.minimum(torch.maximum(y * rz, -lim_y_neg), lim_y_pos)
    zeros = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([fx * rz, zeros, -fx * tx * rz2], dim=-1),
        torch.stack([zeros, fy * rz, -fy * ty * rz2], dim=-1),
    ], dim=-2)
    means2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)
    return means2d, _sandwich(J, covars)


def ortho_proj(means: torch.Tensor, covars: torch.Tensor, Ks: torch.Tensor,
               width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthographic projection: fx and fy are pixels per world unit."""
    x, y = means[..., 0], means[..., 1]
    fx, fy = Ks[..., 0, 0], Ks[..., 1, 1]
    cx, cy = Ks[..., 0, 2], Ks[..., 1, 2]
    f = torch.stack([fx, fy], dim=-1)
    covars2d = covars[..., :2, :2] * (f[..., :, None] * f[..., None, :])
    means2d = torch.stack([fx * x + cx, fy * y + cy], dim=-1)
    return means2d, covars2d


def fisheye_proj(means: torch.Tensor, covars: torch.Tensor, Ks: torch.Tensor,
                 width: int, height: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equidistant fisheye projection. On the optical axis (x = y = 0) the
    gradient of sqrt(x^2 + y^2) is infinite, as in the JAX package."""
    x, y, z = means.unbind(-1)
    fx, fy = Ks[..., 0, 0], Ks[..., 1, 1]
    cx, cy = Ks[..., 0, 2], Ks[..., 1, 2]
    eps = 1e-7
    xy_len = torch.sqrt(x * x + y * y) + eps
    theta = torch.atan2(xy_len, z + eps)
    means2d = torch.stack([x * fx * theta / xy_len + cx,
                           y * fy * theta / xy_len + cy], dim=-1)

    x2 = x * x + eps
    y2 = y * y
    xy = x * y
    x2y2 = x2 + y2
    x2y2z2_inv = 1.0 / (x2y2 + z * z)
    b = torch.atan2(xy_len, z) / xy_len / x2y2
    a = z * x2y2z2_inv / x2y2
    J = torch.stack([
        torch.stack([fx * (x2 * a + y2 * b), fx * xy * (a - b),
                     -fx * x * x2y2z2_inv], dim=-1),
        torch.stack([fy * xy * (a - b), fy * (y2 * a + x2 * b),
                     -fy * y * x2y2z2_inv], dim=-1),
    ], dim=-2)
    return means2d, _sandwich(J, covars)


_PROJ_FNS = {"pinhole": persp_proj, "ortho": ortho_proj,
             "fisheye": fisheye_proj}


def proj(means: torch.Tensor, covars: torch.Tensor, Ks: torch.Tensor,
         width: int, height: int, camera_model: str = "pinhole"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-space means [C,N,3] and covars [C,N,3,3] with Ks [C,3,3] ->
    (means2d [C,N,2], covars2d [C,N,2,2])."""
    if camera_model not in _PROJ_FNS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    return _PROJ_FNS[camera_model](means, covars, Ks[:, None], width, height)


def _inverse2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 2, 2]; zero where the determinant is."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    inv = torch.stack([torch.stack([c, -b], dim=-1),
                       torch.stack([-b, a], dim=-1)], dim=-2) \
        * inv_det[..., None, None]
    return torch.where(det[..., None, None] == 0, torch.zeros_like(inv), inv)


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
    covars: Optional[torch.Tensor],  # [N, 3, 3] or None
    quats: Optional[torch.Tensor],  # [N, 4]
    scales: Optional[torch.Tensor],  # [N, 3]
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
    """Fused world->2D projection with culling, for the pinhole, ortho
    and fisheye cameras, from quats and scales or explicit ``covars``.

    Returns (radii [C,N] or [C,N,2] int32, means2d [C,N,2], depths [C,N],
    conics [C,N,3], compensations [C,N] or None). With ``opacities`` the
    radius is the exact alpha-threshold extent min(3, sqrt(2 ln(255 op)))
    sigmas instead of 3 sigmas."""
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    if camera_model == "pinhole" and covars is None:
        return _fused_projection_pinhole(
            means, quats, scales, viewmats, Ks, width, height, eps2d,
            near_plane, far_plane, radius_clip, calc_compensations,
            opacities, elliptical,
        )
    if covars is None:
        if quats is None or scales is None:
            raise ValueError("pass covars, or quats and scales")
        covars = quat_scale_to_covar(quats, scales)  # [N, 3, 3]

    means_c = pos_world_to_cam(viewmats, means)  # [C, N, 3]
    covars_c = covar_world_to_cam(viewmats, covars)  # [C, N, 3, 3]
    depths = means_c[..., 2]
    means2d, covars2d = proj(means_c, covars_c, Ks, width, height,
                             camera_model)

    # the low-pass blur and the antialiasing compensation
    det_orig = covars2d[..., 0, 0] * covars2d[..., 1, 1] \
        - covars2d[..., 0, 1] * covars2d[..., 1, 0]
    covars2d = covars2d + eps2d * torch.eye(2, dtype=covars2d.dtype,
                                            device=covars2d.device)
    det = covars2d[..., 0, 0] * covars2d[..., 1, 1] \
        - covars2d[..., 0, 1] * covars2d[..., 1, 0]
    compensations = torch.sqrt(torch.clamp(
        det_orig / torch.clamp(det, min=1e-30), min=0.0))
    inv = _inverse2x2(covars2d)
    conics = torch.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]],
                         dim=-1)

    # nsig sigmas of the largest eigenvalue (the exact alpha-threshold
    # extent with opacities), or the per-axis AABB with ``elliptical``
    b = 0.5 * (covars2d[..., 0, 0] + covars2d[..., 1, 1])
    v1 = b + torch.sqrt(torch.clamp(b * b - det, min=0.01))
    nsig = 3.0
    if opacities is not None:
        nsig = torch.clamp(torch.clamp(
            torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * opacities,
                                                   min=1e-30))),
            max=3.0,
        ), min=0.0)[None, :]
    if elliptical:
        rx = torch.ceil(nsig * torch.sqrt(torch.clamp(covars2d[..., 0, 0],
                                                      min=0.0)))
        ry = torch.ceil(nsig * torch.sqrt(torch.clamp(covars2d[..., 1, 1],
                                                      min=0.0)))
    else:
        rx = ry = torch.ceil(nsig * torch.sqrt(v1))

    valid = (depths > near_plane) & (depths < far_plane) & (det > 0)
    valid &= torch.maximum(rx, ry) > radius_clip
    x2d, y2d = means2d[..., 0], means2d[..., 1]
    valid &= (x2d + rx > 0) & (x2d - rx < width)
    valid &= (y2d + ry > 0) & (y2d - ry < height)

    zero = torch.zeros((), dtype=means2d.dtype, device=means2d.device)
    if elliptical:
        radii = torch.where(valid[..., None], torch.stack([rx, ry], dim=-1),
                            zero).to(torch.int32)
    else:
        radii = torch.where(valid, rx, zero).to(torch.int32)
    means2d = torch.where(valid[..., None], means2d, zero)
    depths = torch.where(valid, depths, zero)
    conics = torch.where(valid[..., None], conics, zero)
    if calc_compensations:
        return radii, means2d, depths, conics, torch.where(
            valid, compensations, zero)
    return radii, means2d, depths, conics, None


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
