"""World -> camera rigid transforms (port of
gscodec_studio_tpu/ops/transforms.py)."""

from __future__ import annotations

import torch


def pos_world_to_cam(viewmats: torch.Tensor,
                     means: torch.Tensor) -> torch.Tensor:
    """viewmats [C, 4, 4] world->cam; means [N, 3] -> [C, N, 3]."""
    R = viewmats[:, :3, :3]
    t = viewmats[:, :3, 3]
    return torch.einsum("cij,nj->cni", R, means) + t[:, None, :]


def covar_world_to_cam(viewmats: torch.Tensor,
                       covars: torch.Tensor) -> torch.Tensor:
    """R Sigma R^T. viewmats [C, 4, 4]; covars [N, 3, 3] -> [C, N, 3, 3]."""
    R = viewmats[:, :3, :3]
    return torch.einsum("cij,njk,clk->cnil", R, covars, R)
