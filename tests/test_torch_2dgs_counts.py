"""raster_v2_2dgs._bwd_2dgs_counts, the count of what the 2DGS tile
backward sums over a tile's pixels, against a count by hand on a scene
whose footprints are known in closed form; and the candidate regions
(_pair_regions) inside which the backward evaluates a pair, which must hold
every pixel that passes the alpha test.

Each surfel's ray transform is M = [[s, 0, u0], [0, s, v0], [0, 0, 1]]
with its mean at (u0, v0), a pixel centre, so at a pixel d away
gw3d = d^2 / s^2 and the screen filter gw2d = 2 d^2. With s = 0.1 the
filter sets sigma = d^2 and alpha = op * exp(-d^2), which passes 1/255
where d^2 <= ln(255 op): at op = 0.9 on the 21 pixels with
dx^2 + dy^2 <= 5, at op = 0.008 on the centre pixel alone.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as rv
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as r2

TS = 8  # two 8 x 8 tiles side by side, 64 pixels each


def _hand_scene(cutoff):
    # (pixel x, pixel y, opacity): A covers rows 1-5 of tile 0 around
    # (3, 3), B and C one pixel of tile 0 (rows 6 and 1), D one pixel of
    # tile 1 (row 4)
    surfels = [(3, 3, 0.9), (1, 6, 0.008), (6, 1, 0.008), (12, 4, 0.008)]
    N = len(surfels)
    s = 0.1
    means2d = torch.tensor([[[x + 0.5, y + 0.5] for x, y, _ in surfels]])
    trans = torch.tensor([[[s, 0.0, x + 0.5, 0.0, s, y + 0.5, 0.0, 0.0, 1.0]
                           for x, y, _ in surfels]])
    opac = torch.tensor([[o for _, _, o in surfels]])
    depths = torch.tensor([[1.0, 2.0, 3.0, 1.5]])
    radii = torch.tensor([[[3, 3], [1, 1], [1, 1], [1, 1]]],
                         dtype=torch.int32)
    colors = torch.rand((1, N, 7), generator=torch.Generator().manual_seed(0))
    cfg = r2.cfg_2dgs(1, 2, 1, TS, 7, rv.CAP_BLOCK, N, cutoff=cutoff)
    b = r2._build_sorted_2dgs(cfg, means2d, trans, colors, opac, depths,
                              radii)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    return cfg, b, masks


@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_bwd_2dgs_counts_match_hand_count(cutoff):
    cfg, b, masks = _hand_scene(cutoff)
    assert int(b.n_isects) == 4
    # B6's layout at 7 channels: two pixels a lane in 8 x 8 cells, so one
    # warp covers a tile; A reaches many lanes of tile 0's warp, B and C
    # one lane each, D one lane of tile 1's
    c1 = r2._bwd_2dgs_counts(b.S, b.starts, masks, cfg)
    assert c1["run"].tolist() == [3, 1]
    assert c1["pairs"].tolist() == [3, 1]
    assert c1["slots"].tolist() == [21 + 1 + 1, 1]
    assert c1["warps_per_tile"] == 1
    assert (c1["pair_warp_hits"], c1["single_lane_hits"]) == (4, 3)
    assert c1["pair_warp_candidates"] == 4
    # every composited pixel lies in its pair's candidate region, and the
    # regions leave most of the 2 x 64 x 4 walked slots out
    assert c1["missed_slots"] == 0
    assert c1["evaluated_slots"] == 64 * 3 + 64
    assert 24 <= c1["candidate_slots"] < c1["evaluated_slots"] // 2
    # the forward's own count of composited (pair, pixel) slots agrees
    _, fc = r2._fwd_2dgs_plain(b.S, b.starts, masks, cfg, 3,
                               with_counts=True)
    assert fc["composited"] == int(c1["slots"].sum())


def test_bwd_pixels_per_thread():
    assert [r2.bwd_pixels_per_thread(cb) for cb in (4, 7, 32, 33, 128)] \
        == [2, 2, 2, 1, 1]


@pytest.mark.parametrize("channels,tile_size,want", [
    (7, 16, (8, 2, 128, 6)),  # train_2dgs: 128 threads, 6 blocks an SM
    (4, 8, (4, 2, 128, 6)),
    (7, 32, (8, 2, 512, 1)),  # 512 threads: the tile-32 build
    (16, 16, (16, 2, 512, 1)),
    (40, 16, (64, 1, 1024, 1)),
])
def test_bwd_build(channels, tile_size, want):
    b = r2.bwd_build(channels, tile_size)
    assert (b["cbm"], b["ppt"], b["max_threads"], b["min_blocks"]) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_regions_hold_every_passing_pixel(seed):
    """Random surfels (some seen edge on, some large) projected at 64x48:
    no pixel that passes the alpha test lies outside its pair's region, and
    the regions prune the walked slots."""
    from gscodec_studio_tpu_torch.rendering import project_and_shade_2dgs

    rng = np.random.default_rng(seed)
    N, W, H = 400, 64, 48
    means = (rng.standard_normal((N, 3)) * [1.0, 0.7, 1.0]).astype(
        np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.8, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 4.0
    K = np.array([[[60, 0, W / 2], [0, 60, H / 2], [0, 0, 1]]], np.float32)
    radii, m2, dep, trans, nrm, col, op = project_and_shade_2dgs(
        *[torch.as_tensor(x) for x in (means, quats, scales, opac, colors)],
        torch.as_tensor(vm[None]), torch.as_tensor(K), W, H)
    colors_full = torch.cat([col, nrm], -1).contiguous()
    cfg = r2.cfg_2dgs(1, W // TS, H // TS, TS, 7, 4 * rv.CAP_BLOCK, N)
    b = r2._build_sorted_2dgs(cfg, m2.contiguous(), trans.contiguous(),
                              colors_full, op.contiguous(), dep.contiguous(),
                              radii.contiguous())
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    c = r2._bwd_2dgs_counts(b.S, b.starts, masks, cfg)
    assert int(c["slots"].sum()) > 1000
    assert c["missed_slots"] == 0
    assert c["candidate_slots"] < c["evaluated_slots"] // 2
    assert c["pair_warp_hits"] <= c["pair_warp_candidates"]


def test_candidate_regions_camera_in_plane():
    """Surfels whose plane passes through the camera (M singular) or within
    1e-6 rad of it, seen along a pixel row (where the float cross product
    of the pixel's planes is rounding noise), get no candidate region, and
    a surfel seen face on keeps its bound; no composited pixel is missed."""
    f, z = 20.0, 2.1
    Kc = np.array([[f, 0.0, 7.5], [0.0, f, 3.5], [0.0, 0.0, 1.0]])
    c30, s30, e = np.cos(np.pi / 6), np.sin(np.pi / 6), 1e-6
    # (tu, tv, centre): the plane y = 0, the same turned 30 degrees about
    # the view ray, the first tilted by e, and one face on
    frames = [((1, 0, 0), (0, 0, 1), (0, 0, z)),
              ((c30, s30, 0), (0, 0, 1), (0, 0, z)),
              ((1, 0, 0), (0, np.sin(e), np.cos(e)), (0, 0, z)),
              ((1, 0, 0), (0, 1, 0), (0.4, 0.1, z))]
    su, sv = 0.3, 0.2
    M, xy = [], []
    for tu, tv, c in frames:
        WH = np.stack([su * np.array(tu), sv * np.array(tv), c], 1)
        M.append((Kc @ WH).astype(np.float32).ravel())
        p = Kc @ np.array(c)
        xy.append(p[:2] / p[2])
    N = len(frames)
    trans = torch.tensor(np.array(M))[None]
    means2d = torch.tensor(np.array(xy), dtype=torch.float32)[None]
    opac = torch.full((1, N), 0.9)
    depths = torch.tensor([[z, z + 0.1, z + 0.2, z + 0.3]])
    radii = torch.full((1, N, 2), 8, dtype=torch.int32)
    colors = torch.rand((1, N, 7), generator=torch.Generator().manual_seed(1))
    cfg = r2.cfg_2dgs(1, 2, 1, TS, 7, rv.CAP_BLOCK, N, cutoff="exact")
    b = r2._build_sorted_2dgs(cfg, means2d, trans, colors, opac, depths,
                              radii)
    rows = torch.zeros((b.S.shape[0], N))
    rows[r2._AX:r2._AY + 1] = means2d[0].T
    rows[r2._AM:r2._AM + 9] = trans[0].T
    rows[r2._AOP] = opac[0]
    _, _, qa, qb, qc, bound, _ = r2._pair_regions(rows)
    unbounded = (qa == 0) & (qb == 0) & (qc == 0)
    assert unbounded.tolist() == [True, True, True, False]
    assert bound.tolist() == [1.0] * N
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    c = r2._bwd_2dgs_counts(b.S, b.starts, masks, cfg)
    assert int(c["slots"].sum()) > 0
    assert c["missed_slots"] == 0
