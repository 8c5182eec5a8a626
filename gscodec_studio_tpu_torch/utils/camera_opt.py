"""Per-image camera pose refinement and appearance (port of
gscodec_studio_tpu/utils/camera_opt.py).

Pose: a learned SE(3) delta per training image, 3 translation and the 6D
rotation parameterisation (Zhou et al.), right-multiplied onto its c2w.
Appearance: a per-image embedding and a per-Gaussian feature, with the SH
basis of the view direction, through a small MLP to per-(camera, Gaussian)
colour offsets. ``AppearanceOptModule`` holds the appearance parameters;
the functions take them as plain tensors, as the trainer's functional Adam
updates them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from gscodec_studio_tpu_torch.ops.sh import num_sh_bases, sh_basis


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt on the two learned axes
    (the rows of the result)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1,
                                                   keepdim=True), min=1e-8)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1,
                                                    keepdim=True), min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def camera_opt_init(n_images: int, device=None) -> torch.Tensor:
    """Identity deltas [n, 9]: translation 0, 6D rotation (1,0,0, 0,1,0)."""
    base = torch.zeros((n_images, 9), device=device)
    base[:, 3] = 1.0
    base[:, 7] = 1.0
    return base


def camera_opt_apply(params: torch.Tensor, camtoworlds: torch.Tensor,
                     image_ids: torch.Tensor) -> torch.Tensor:
    """c2w' = c2w @ [R | t] with each image's delta ([B, 4, 4])."""
    p = params[image_ids]  # [B, 9]
    R = rotation_6d_to_matrix(p[..., 3:])
    top = torch.cat([R, p[..., :3, None]], dim=-1)  # [B, 3, 4]
    bottom = torch.zeros(p.shape[:-1] + (1, 4), dtype=p.dtype,
                         device=p.device)
    bottom[..., 0, 3] = 1.0
    return camtoworlds @ torch.cat([top, bottom], dim=-2)


class _Dense(nn.Module):
    """h @ w + b with w stored [in, out], the JAX package's layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class AppearanceOptModule(nn.Module):
    """Per-image embeddings ``embeds`` [n, embed_dim] (zero at the start)
    and an MLP of two layers, 64 wide, from
    embed_dim + feature_dim + (sh_degree + 1)^2 inputs to 3 colour
    offsets; weights normal times sqrt(2 / fan_in), biases zero."""

    def __init__(self, n_images: int, feature_dim: int = 32,
                 embed_dim: int = 16, sh_degree: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        in_dim = embed_dim + feature_dim + num_sh_bases(sh_degree)
        self.sh_degree = sh_degree
        self.embeds = nn.Parameter(torch.zeros((n_images, embed_dim),
                                               device=device))
        dims = [in_dim, 64, 3]
        self.mlp = nn.ModuleList(
            _Dense(math.sqrt(2.0 / dims[i]) * torch.randn(
                (dims[i], dims[i + 1]), generator=generator, device=device),
                torch.zeros(dims[i + 1], device=device))
            for i in range(len(dims) - 1))

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        return [{"w": layer.w, "b": layer.b} for layer in self.mlp]

    def forward(self, features, image_ids, dirs, sh_degree: int):
        return appearance_opt_apply(self.embeds, self.layers(), features,
                                    image_ids, dirs, sh_degree,
                                    sh_degree_max=self.sh_degree)


def appearance_opt_apply(
    embeds: torch.Tensor,  # [n_images, e]
    mlp: List[Dict[str, torch.Tensor]],  # [{"w": [in, out], "b": [out]}]
    features: torch.Tensor,  # [N, feature_dim]
    image_ids: torch.Tensor,  # [C]
    dirs: torch.Tensor,  # [C, N, 3]
    sh_degree: int,
    sh_degree_max: Optional[int] = None,
) -> torch.Tensor:
    """Per-(camera, Gaussian) colour offsets [C, N, 3]. The MLP's input
    width is fixed by ``sh_degree_max``: while training warms the active
    ``sh_degree`` up, the unused higher bases are zero."""
    C, N = dirs.shape[:2]
    emb = embeds[image_ids]  # [C, e]
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    basis = sh_basis(sh_degree, dirs)  # [C, N, K_use]
    if sh_degree_max is not None and sh_degree_max != sh_degree:
        pad = num_sh_bases(sh_degree_max) - basis.shape[-1]
        basis = torch.cat([basis, basis.new_zeros((C, N, pad))], dim=-1)
    h = torch.cat([emb[:, None, :].expand(C, N, emb.shape[-1]),
                   features[None].expand(C, N, features.shape[-1]), basis],
                  dim=-1)
    for i, layer in enumerate(mlp):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(mlp):
            h = torch.relu(h)
    return h
