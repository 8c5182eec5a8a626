"""Tile binning for the legacy v1 rasterizer (port of
gscodec_studio_tpu/ops/isect.py): which Gaussians touch which screen tiles,
as a fixed-capacity intersection list sorted by (tile, depth), and its
tile-aligned re-layout for ops/rasterize_pallas.py.

Plain PyTorch, as the JAX package leaves it to XLA. The translation:
  * ``jnp.repeat(..., total_repeat_length=capacity)`` truncates when the
    total exceeds the capacity; ``torch.repeat_interleave`` does not, so the
    expansion's source index is a search of the counts' running sum;
  * the two-key ``jax.lax.sort`` on (int32 tile key, int32 depth bits) is
    one ``torch.sort`` of the int64 key ``tile << 32 | (depth bits + 2^31)``
    (the offset keeps the signed order of the second key); padding is
    INT32_MAX in both halves and sorts last;
  * ``jax.lax.sort`` is not stable and ``torch.sort(stable=True)`` is: the
    two agree wherever no two entries share both keys.
All outputs are indices and carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2**31 - 1


class Intersections(NamedTuple):
    """Sorted tile-intersection list (static capacity).

    tiles_per_gauss: [C, N] int32
    tile_keys:       [cap] int32, cam*TH*TW + tile, sorted; INT32_MAX padding
    depths:          [cap] f32 (sorted secondary key)
    flatten_ids:     [cap] int32, cam*N + gauss per sorted entry
    n_isects:        scalar int32 (true count clamped to cap)
    exp_offsets:     [C*N + 1] int32, start of each (cam, gauss)'s run in
                     expansion (pre-sort) order
    inv_perm:        [cap] int32, expansion position -> sorted position
                     ([1] zeros when not asked for)
    """

    tiles_per_gauss: torch.Tensor
    tile_keys: torch.Tensor
    depths: torch.Tensor
    flatten_ids: torch.Tensor
    n_isects: torch.Tensor
    exp_offsets: torch.Tensor
    inv_perm: torch.Tensor


def isect_tiles(means2d, radii, depths, tile_size: int, tile_width: int,
                tile_height: int, capacity: int,
                need_inv_perm: bool = True) -> Intersections:
    """Bin Gaussians ([C, N] scalar ``radii``, 0 = culled) to tiles; see
    :class:`Intersections`. ``need_inv_perm=False`` skips the inverse
    permutation, which only the "cumsum" and "reference" paths read."""
    C, N = radii.shape
    dev = means2d.device
    n_tiles = tile_width * tile_height
    if C * n_tiles >= INT32_MAX:
        raise ValueError("tile key overflows int32")
    i32 = torch.int32

    tm = means2d / tile_size
    tr = radii.to(means2d.dtype) / tile_size
    x0 = torch.clamp(torch.floor(tm[..., 0] - tr), 0, tile_width).to(i32)
    y0 = torch.clamp(torch.floor(tm[..., 1] - tr), 0, tile_height).to(i32)
    x1 = torch.clamp(torch.ceil(tm[..., 0] + tr), 0, tile_width).to(i32)
    y1 = torch.clamp(torch.ceil(tm[..., 1] + tr), 0, tile_height).to(i32)
    nx = x1 - x0
    tiles_per_gauss = torch.where(radii > 0, nx * (y1 - y0),
                                  torch.zeros_like(nx))

    counts = tiles_per_gauss.reshape(-1).to(torch.int64)
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    offsets = cum - counts
    depth_bits = depths.reshape(-1).to(torch.float32).contiguous().view(i32)
    base_key = ((torch.arange(C, device=dev, dtype=torch.int64)
                 * n_tiles)[:, None] + y0 * tile_width + x0).reshape(-1)

    pos = torch.arange(capacity, device=dev, dtype=torch.int64)
    # jnp.repeat's source index, truncated at the capacity
    src = torch.clamp(torch.searchsorted(cum, pos, right=True),
                      max=C * N - 1)
    valid = pos < torch.clamp(total, max=capacity)
    rank = pos - offsets[src]
    nx_s = torch.clamp(nx.reshape(-1)[src].to(torch.int64), min=1)
    keys = base_key[src] + torch.div(rank, nx_s, rounding_mode="floor") \
        * tile_width + rank % nx_s
    tile_keys = torch.where(valid, keys, INT32_MAX)
    depth_keys = torch.where(valid, depth_bits[src].to(torch.int64),
                             INT32_MAX)
    flatten_ids = torch.where(valid, src, 0).to(i32)

    sort_key = (tile_keys << 32) | (depth_keys + 2**31)
    _, sorted_pos = torch.sort(sort_key, stable=True)
    tile_keys = tile_keys[sorted_pos].to(i32)
    depth_keys = depth_keys[sorted_pos].to(i32)
    flatten_ids = flatten_ids[sorted_pos]
    if need_inv_perm:
        inv_perm = torch.empty(capacity, dtype=i32, device=dev)
        inv_perm[sorted_pos] = pos.to(i32)
    else:
        inv_perm = torch.zeros(1, dtype=i32, device=dev)
    exp_offsets = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                             torch.clamp(cum, max=capacity).to(i32)])
    n_isects = torch.clamp(total, max=capacity).to(i32)
    return Intersections(tiles_per_gauss, tile_keys, depth_keys.view(
        torch.float32), flatten_ids, n_isects, exp_offsets, inv_perm)


class AlignedIsects(NamedTuple):
    """The sorted list with every tile's run padded to a multiple of
    ``align`` entries.

    ids:      [cap2] int32, cam*N + gauss per aligned slot; -1 in padding
    starts:   [T] int32 aligned start of each tile's run
    ends:     [T] int32 true (unpadded) end of each tile's run
    inv_perm: [cap] int32 expansion position -> aligned position ([1]
              zeros when not asked for)
    n_isects: scalar int32
    """

    ids: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    inv_perm: torch.Tensor
    n_isects: torch.Tensor


def align_isects(isect: Intersections, C: int, tile_width: int,
                 tile_height: int, align: int = 128,
                 need_inv_perm: bool = True) -> AlignedIsects:
    """Re-lay the sorted list with per-tile runs padded to ``align``
    entries: entry j of tile t moves to j + (aligned start - start) of t.
    Every padding entry of the sorted list is written to the dump slot
    cap2 - 1; all of those writes carry -1."""
    cap = isect.tile_keys.shape[0]
    T = C * tile_width * tile_height
    dev = isect.tile_keys.device
    i32 = torch.int32
    offsets = isect_offset_encode(isect.tile_keys, C, tile_width,
                                  tile_height)
    lens = offsets[1:] - offsets[:-1]
    plens = torch.div(lens + align - 1, align, rounding_mode="floor") * align
    astarts = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                         torch.cumsum(plens, 0).to(i32)])
    # room for every run's padding, plus two chunks; the last row is the
    # padding entries' dump slot
    cap2 = ((cap + T * align) // align + 2) * align
    delta = torch.cat([astarts[:-1] - offsets[:-1],
                       torch.full((1,), cap2 - 1, dtype=i32, device=dev)])
    j = torch.arange(cap, dtype=i32, device=dev)
    tkey = torch.clamp(isect.tile_keys, max=T)
    real = tkey < T
    new_pos = torch.where(real, j + delta[tkey.to(torch.int64)], cap2 - 1)
    ids = torch.full((cap2,), -1, dtype=i32, device=dev)
    ids[new_pos.to(torch.int64)] = torch.where(real, isect.flatten_ids, -1)
    inv_perm = (new_pos[isect.inv_perm.to(torch.int64)] if need_inv_perm
                else torch.zeros(1, dtype=i32, device=dev))
    return AlignedIsects(ids=ids, starts=astarts[:-1],
                         ends=astarts[:-1] + lens, inv_perm=inv_perm,
                         n_isects=isect.n_isects)


def isect_offset_encode(tile_keys, C: int, tile_width: int,
                        tile_height: int) -> torch.Tensor:
    """Start of each tile's run in the sorted list, [C*TH*TW + 1] int32:
    tile t owns entries [offsets[t], offsets[t + 1])."""
    targets = torch.arange(C * tile_width * tile_height + 1,
                           dtype=tile_keys.dtype, device=tile_keys.device)
    return torch.searchsorted(tile_keys, targets, right=False).to(
        torch.int32)
