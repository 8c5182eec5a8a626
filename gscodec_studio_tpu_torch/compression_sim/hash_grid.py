"""Multi-resolution hash-grid encoder (Instant-NGP style) and the
position-conditioned Gaussian entropy model built on it (port of
gscodec_studio_tpu/compression_sim/hash_grid.py): a 3D hash grid, three
2D grids on the coordinate planes and a 2-layer MLP regress a Gaussian's
(mean, scale) per attribute channel from its normalized position.

Plain PyTorch: a training step gathers 16,384 points' corners (8 corners
at each 3D level, 4 at each plane level), which needs no kernel of its own.
The gather's backward scatters into the tables; on CUDA it adds with
atomics, in an order that changes from run to run.

A model's parameters are {"grid3d": [L3, T3, 2], "planes": [3 x [L2, T2,
2]], "mlp": [{"w", "b"}, {"w", "b"}]}, the JAX package's tree.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gscodec_studio_tpu_torch.compression_sim.entropy_model import (
    gaussian_bits)
from gscodec_studio_tpu_torch.compression_sim.ops import ste_binary

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


class HashGridCfg(NamedTuple):
    n_levels: int = 12
    n_features: int = 2
    table_size: int = 1 << 19
    base_resolution: int = 16
    per_level_scale: float = 1.447
    dim: int = 3


def hash_grid_init(n_levels: int = 12, n_features: int = 2,
                   log2_hashmap_size: int = 19, base_resolution: int = 16,
                   per_level_scale: float = 1.447, dim: int = 3,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, HashGridCfg]:
    """-> (tables [n_levels, table_size, n_features] uniform in +-1e-4 from
    ``generator``, cfg)."""
    cfg = HashGridCfg(n_levels=n_levels, n_features=n_features,
                      table_size=1 << log2_hashmap_size,
                      base_resolution=base_resolution,
                      per_level_scale=per_level_scale, dim=dim)
    u = torch.rand((n_levels, cfg.table_size, n_features),
                   generator=generator, device=device)
    return (u * 2.0 - 1.0) * 1e-4, cfg


def _hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of non-negative integer coords [..., dim] ->
    [0, table_size), the JAX version's uint32 arithmetic with wraparound:
    each product is taken in int64 and cut to 32 bits before the XOR."""
    c = coords.to(torch.int64) & _MASK32
    h = (c[..., 0] * _PRIMES[0]) & _MASK32
    for d in range(1, coords.shape[-1]):
        h = h ^ ((c[..., d] * _PRIMES[d % 3]) & _MASK32)
    return h % table_size


def _corner_offsets(dim: int, device) -> torch.Tensor:
    return torch.tensor([[(c >> d) & 1 for d in range(dim)]
                         for c in range(1 << dim)], dtype=torch.int32,
                        device=device)


def hash_grid_encode(tables: torch.Tensor, cfg: HashGridCfg, x: torch.Tensor,
                     binarize: bool = False) -> torch.Tensor:
    """x [N, dim] in [0, 1] -> [N, n_levels * n_features]: at each level
    the multilinear interpolation of the 2^dim hashed corner embeddings.
    ``binarize`` reads the tables through the STE sign. All levels' corners
    are gathered from the flattened tables in one index_select, whose
    backward is one index_add_ into one gradient buffer: on an H100 one
    3D grid's gather and backward take 0.44 ms so, 2.88 ms gathered level
    by level by advanced indexing (chip_smoke.py's garden_recipe)."""
    dim = cfg.dim
    if binarize:
        tables = ste_binary(tables)
    offsets = _corner_offsets(dim, x.device)  # [2^dim, dim]
    xc = torch.clamp(x, 0.0, 1.0)
    idx, wts = [], []
    for lvl in range(cfg.n_levels):
        res = int(math.floor(cfg.base_resolution * cfg.per_level_scale ** lvl))
        xs = xc * (res - 1)
        x0 = torch.floor(xs).to(torch.int32)
        f = xs - x0  # [N, dim]
        corners = torch.clamp(x0[:, None, :] + offsets[None], 0, res - 1)
        idx.append(_hash(corners, cfg.table_size) + lvl * cfg.table_size)
        w = torch.ones(f.shape[:1] + (1 << dim,), dtype=x.dtype,
                       device=x.device)
        for d in range(dim):
            fd = f[:, d:d + 1]
            w = w * torch.where(offsets[None, :, d] == 1, fd, 1 - fd)
        wts.append(w)
    idx = torch.stack(idx, 1)  # [N, L, 2^dim]
    emb = torch.index_select(tables.reshape(-1, cfg.n_features), 0,
                             idx.reshape(-1)).reshape(
        idx.shape + (cfg.n_features,))
    out = (torch.stack(wts, 1)[..., None] * emb).sum(2)  # [N, L, F]
    return out.reshape(x.shape[0], -1)


def gaussian_conditional_init(channel: int, n_levels_3d: int = 12,
                              n_levels_2d: int = 4, mlp_width: int = 64,
                              log2_hashmap_3d: int = 19,
                              log2_hashmap_2d: int = 17,
                              generator: Optional[torch.Generator] = None,
                              device=None) -> Tuple[Dict, tuple]:
    """The (mean, scale) regressor's parameters and its static cfgs
    (cfg3d, cfg2d, channel): tables uniform in +-1e-4, He-normal MLP
    weights and zero biases, all drawn from ``generator``."""
    grid3d, cfg3d = hash_grid_init(n_levels=n_levels_3d, dim=3,
                                   log2_hashmap_size=log2_hashmap_3d,
                                   generator=generator, device=device)
    planes, cfg2d = [], None
    for _ in range(3):
        t, cfg2d = hash_grid_init(n_levels=n_levels_2d, dim=2,
                                  log2_hashmap_size=log2_hashmap_2d,
                                  generator=generator, device=device)
        planes.append(t)
    in_dim = n_levels_3d * 2 + 3 * n_levels_2d * 2

    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, device=device)

    mlp = [
        {"w": normal((in_dim, mlp_width), (2.0 / in_dim) ** 0.5),
         "b": torch.zeros(mlp_width, device=device)},
        {"w": normal((mlp_width, 2 * channel), (2.0 / mlp_width) ** 0.5),
         "b": torch.zeros(2 * channel, device=device)},
    ]
    return {"grid3d": grid3d, "planes": planes, "mlp": mlp}, \
        (cfg3d, cfg2d, channel)


PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def gaussian_conditional_cfgs(params: Dict) -> tuple:
    """The static cfgs (cfg3d, cfg2d, channel) of a model made by
    gaussian_conditional_init at the default resolutions, read from its
    tensors' shapes."""
    g3, p0 = params["grid3d"], params["planes"][0]
    cfg3d = HashGridCfg(n_levels=g3.shape[0], n_features=g3.shape[2],
                        table_size=g3.shape[1], dim=3)
    cfg2d = HashGridCfg(n_levels=p0.shape[0], n_features=p0.shape[2],
                        table_size=p0.shape[1], dim=2)
    return cfg3d, cfg2d, params["mlp"][-1]["w"].shape[1] // 2


def gaussian_conditional_apply(params: Dict, cfgs, pos: torch.Tensor,
                               binarize: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [N, 3] in [0, 1] -> (mean [N, C], scale [N, C])."""
    cfg3d, cfg2d, channel = cfgs
    feats = [hash_grid_encode(params["grid3d"], cfg3d, pos, binarize)]
    for axes, plane in zip(PLANE_AXES, params["planes"]):
        feats.append(hash_grid_encode(plane, cfg2d, pos[:, list(axes)],
                                      binarize))
    h = torch.cat(feats, dim=-1)
    layers = params["mlp"]
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(layers):
            h = torch.relu(h)
    mean, raw_scale = h[:, :channel], h[:, channel:]
    return mean, F.softplus(raw_scale) + 1e-4


def gaussian_conditional_bits(params: Dict, cfgs, x: torch.Tensor,
                              pos: torch.Tensor, q_step: float,
                              binarize: bool = False) -> torch.Tensor:
    """Estimated bits [N, C] of the quantized values x [N, C] under the
    position-conditioned Gaussian."""
    mean, scale = gaussian_conditional_apply(params, cfgs, pos, binarize)
    return gaussian_bits(x, mean, scale, q_step)
