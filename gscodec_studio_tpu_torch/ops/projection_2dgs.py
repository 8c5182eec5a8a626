"""2DGS (surfel) projection: world-space 2D Gaussian disks -> per-camera
ray-transform matrices (port of gscodec_studio_tpu/ops/projection_2dgs.py).

Each surfel yields M = K @ WH with WH = [R s_x e_x, R s_y e_y, mean_cam]
(rows of M stored row-major, the reference CUDA storage convention): a
pixel's homogeneous-plane cross product against M's rows gives the ray's
hit point in the surfel's UV frame. Plain tensor math; autograd supplies
the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gscodec_studio_tpu_torch.ops.quat import quat_to_rotmat
from gscodec_studio_tpu_torch.ops.transforms import pos_world_to_cam


def fully_fused_projection_2dgs(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] (z ignored)
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    opacities=None,  # [N] linear opacity -> exact alpha-threshold extent
    elliptical: bool = False,  # radii as per-axis AABB half-widths [C,N,2]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Returns (radii [C,N] or [C,N,2] int32, means2d [C,N,2], depths
    [C,N], ray_transforms [C,N,3,3] (rows = K @ WH rows), normals [C,N,3]).
    Invalid surfels (behind the near plane, past the far plane, degenerate,
    off screen or below radius_clip) get radius 0 and zero outputs."""
    R_wc = viewmats[:, :3, :3]  # [C, 3, 3]
    mean_c = pos_world_to_cam(viewmats, means)  # [C, N, 3]
    depths = mean_c[..., 2]

    R_g = quat_to_rotmat(quats)  # [N, 3, 3]
    # RS_camera = R_wc @ R_g @ diag(sx, sy, 1)  [C, N, 3, 3]
    RS = torch.einsum("cij,njk->cnik", R_wc, R_g)
    sdiag = torch.stack(
        [scales[:, 0], scales[:, 1], torch.ones_like(scales[:, 0])], dim=-1)
    RS = RS * sdiag[None, :, None, :]

    # WH columns: [RS[:, 0], RS[:, 1], mean_c]; M rows are the rows of K WH
    WH = torch.stack([RS[..., :, 0], RS[..., :, 1], mean_c], dim=-1)
    M = torch.einsum("cij,cnjk->cnik", Ks, WH)  # [C, N, 3, 3]

    M0, M1, M2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    temp = torch.tensor([1.0, 1.0, -1.0], dtype=M.dtype, device=M.device)
    distance = (temp * M2 * M2).sum(-1)  # [C, N]
    safe_dist = torch.where(distance == 0, torch.ones_like(distance),
                            distance)
    f = temp / safe_dist[..., None]
    mean2d = torch.stack([(f * M0 * M2).sum(-1), (f * M1 * M2).sum(-1)],
                         dim=-1)
    tmp2 = torch.stack([(f * M0 * M0).sum(-1), (f * M1 * M1).sum(-1)],
                       dim=-1)
    half_extend = mean2d * mean2d - tmp2
    if opacities is None:
        nsig = torch.tensor(3.0, dtype=M.dtype, device=M.device)
    else:
        # alpha = op * exp(-sigma), sigma quadratic in the per-axis extent:
        # past nsig = sqrt(2 ln(255 op)) sigma a pair is below 1/255
        nsig = torch.clamp(torch.clamp(torch.sqrt(2.0 * torch.log(
            torch.clamp(255.0 * opacities, min=1e-30))), max=3.0),
            min=0.0)[None, :]
    he = torch.sqrt(torch.clamp(half_extend, min=1e-4))  # [C, N, 2]
    if elliptical:
        rx = torch.ceil(nsig * he[..., 0])
        ry = torch.ceil(nsig * he[..., 1])
    else:
        rx = ry = torch.ceil(nsig * he.amax(dim=-1))

    valid = (depths > near_plane) & (depths < far_plane) & (distance != 0)
    valid &= torch.maximum(rx, ry) > radius_clip
    x2d, y2d = mean2d[..., 0], mean2d[..., 1]
    valid &= (x2d + rx > 0) & (x2d - rx < width)
    valid &= (y2d + ry > 0) & (y2d - ry < height)

    # the normal: RS_camera's third column, flipped toward the camera
    normal = RS[..., :, 2]
    flip = torch.where((-normal * mean_c).sum(-1) > 0, 1.0, -1.0)
    normal = normal * flip[..., None]

    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    if elliptical:
        radii = torch.where(valid[..., None], torch.stack([rx, ry], -1),
                            zero).to(torch.int32)
    else:
        radii = torch.where(valid, rx, zero).to(torch.int32)
    mean2d = torch.where(valid[..., None], mean2d, zero)
    depths = torch.where(valid, depths, zero)
    M = torch.where(valid[..., None, None], M, zero)
    normal = torch.where(valid[..., None], normal, zero)
    return radii, mean2d, depths, M, normal
