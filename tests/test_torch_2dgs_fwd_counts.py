"""raster_v2_2dgs._fwd_2dgs_counts, the count of what the 2DGS tile
forward (B5) evaluates, against a pair-by-pair walk of B5's layout written
out here, in both cutoffs and in the product and the log-space scan; and
raster_v2_2dgs.fwd_build, the build that a launch takes, case by case.

B5's layout (csrc/raster_fwd_2dgs.cu): 2 pixels a lane at up to 32
channels (a warp's 32 lanes an 8 x 8 pixel cell), or 1 (8 x 4) above, the
cells row-major; a warp tests a pair's pixels where its cell meets the box
of the pair's region (raster_v2_2dgs._pair_boxes), and a pixel is a
candidate where it lies in the region (raster_v2_2dgs._candidates, B6's
regions). The walk
takes the plain forward's transmittance, pair after pair: T_prev the
running product of 1 - alpha from the chunk's start, or T * exp(s1 + s2 -
l) in the log scan; the exact cutoff ends a pixel's chunk before the first
pair whose inclusive T falls to 1e-4 or below, and the soft cutoff ends the
tile when every pixel has T <= 1e-4 at a chunk's start.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as rv
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as r2

K = rv.K
TS = 8


def _surfels(seed, CB, N=300, W=48, H=32):
    """Seeded surfels projected at 48 x 32 (tiles of 8: a 6 x 4 grid),
    with CB - 4 user channels beside the depth and the normals."""
    from gscodec_studio_tpu_torch.rendering import project_and_shade_2dgs

    rng = np.random.default_rng(seed)
    means = (rng.standard_normal((N, 3)) * [1.0, 0.7, 1.0]).astype(
        np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-2.3, 0.6, (N, 3))).astype(np.float32)
    opac = (0.2 + 0.8 * rng.random(N)).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 4.0
    Kc = np.array([[[45, 0, W / 2], [0, 45, H / 2], [0, 0, 1]]], np.float32)
    radii, m2, dep, trans, nrm, col, op = project_and_shade_2dgs(
        *[torch.as_tensor(x) for x in (means, quats, scales, opac, colors)],
        torch.as_tensor(vm[None]), torch.as_tensor(Kc), W, H)
    user = torch.as_tensor(rng.random((1, N, CB - 4)), dtype=torch.float32)
    colors_full = torch.cat([user, col[..., 3:], nrm], -1).contiguous()
    return (m2.contiguous(), trans.contiguous(), colors_full,
            op.contiguous(), dep.contiguous(), radii.contiguous())


def _walk(S, starts, masks, cfg, ppt):
    """The counts of _fwd_2dgs_counts, pair by pair, in the layout of
    ``ppt`` pixels a lane."""
    ts, P = cfg.tile_size, cfg.pixels
    ct, rc = 8 // ppt, 32 // (8 // ppt)
    cells_x = -(-ts // 8)
    n_warps = cells_x * -(-ts // rc)
    p = torch.arange(P)
    row, col = p // ts, p % ts
    warp = (row // rc) * cells_x + col // 8
    lane = (row % rc) * ct + (col % 8) // ppt
    out = {k: [0] * cfg.n_tiles for k in ("run", "pairs", "slots")}
    tot = dict.fromkeys(("evaluated_slots", "candidate_slots",
                         "missed_slots", "pair_warp_candidates",
                         "pair_warp_hits", "single_lane_hits",
                         "pair_warp_cells"), 0)
    one = torch.ones((1, 1, 1), dtype=torch.bool)
    for t in range(cfg.n_tiles):
        off, end = int(starts[t]), int(starts[t + 1])
        if end <= off or not masks[t]:
            continue
        tx, ty = t % cfg.tile_width, t // cfg.tile_width
        px = ((tx * ts + col).float() + 0.5)[None, :, None]
        py = ((ty * ts + row).float() + 0.5)[None, :, None]
        cx, cy = torch.arange(n_warps) % cells_x, torch.arange(n_warps) // \
            cells_x
        cells = [(v + 0.5).float() for v in (
            tx * ts + cx * 8, tx * ts + torch.clamp(cx * 8 + 7, max=ts - 1),
            ty * ts + cy * rc, ty * ts + torch.clamp(cy * rc + rc - 1,
                                                    max=ts - 1))]
        T = torch.ones(P)
        for c in range(off // K, -(-end // K)):
            if not bool((T > rv.TRANSMITTANCE_EPS).any()):
                break
            s1, s2 = torch.zeros(P), torch.zeros(P)
            live = torch.ones(P, dtype=torch.bool)
            T0 = T.clone()
            for j in range(max(off, c * K), min(end, (c + 1) * K)):
                chunk = S[:, None, j:j + 1]
                pr = r2._chunk_pair_2dgs(chunk, px, py, one)
                alpha, valid = pr["alpha"][0, :, 0], pr["valid"][0, :, 0]
                if cfg.log_composite:
                    _, l1, l2 = rv._log_split(alpha)
                    s1, s2 = s1 + l1, s2 + l2
                    t_incl = T0 * torch.exp(s1 + s2)
                else:
                    t_incl = T * (1.0 - alpha)
                if cfg.cutoff == "exact":
                    live &= t_incl > rv.TRANSMITTANCE_EPS
                    comp = valid & live
                    T = torch.where(live, t_incl, T)
                else:
                    comp = valid
                    T = t_incl
                x0, x1, y0, y1 = (float(v) for v in r2._pair_boxes(
                    chunk, r2._pair_regions(chunk)))
                box = ((x0 <= cells[1]) & (x1 >= cells[0]) & (y0 <= cells[3])
                       & (y1 >= cells[2]))
                cand = r2._candidates(chunk, px, py)[0, :, 0] & box[warp]
                tot["pair_warp_cells"] += int(box.sum())
                out["run"][t] += 1
                out["pairs"][t] += int(comp.any())
                out["slots"][t] += int(comp.sum())
                tot["evaluated_slots"] += P
                tot["candidate_slots"] += int(cand.sum())
                tot["missed_slots"] += int((valid & ~cand).sum())
                for w in range(n_warps):
                    tot["pair_warp_candidates"] += int(cand[warp == w].any())
                    lanes = {int(v) for v in lane[(warp == w) & comp]}
                    tot["pair_warp_hits"] += int(len(lanes) > 0)
                    tot["single_lane_hits"] += int(len(lanes) == 1)
    return out, tot, n_warps


@pytest.mark.parametrize("CB", [7, 40])
@pytest.mark.parametrize("log_composite", [False, True])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_fwd_2dgs_counts_match_pair_walk(cutoff, log_composite, CB):
    rows = _surfels(0, CB)
    N = rows[0].shape[1]
    cfg = r2.cfg_2dgs(1, 6, 4, TS, CB, rv.CAP_BLOCK, N, cutoff=cutoff,
                      log_composite=log_composite)
    b = r2._build_sorted_2dgs(cfg, *rows)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    masks[5] = 0
    ppt = 2 if CB <= 32 else 1  # 8 x 8 cells, or 8 x 4 above 32 channels
    assert r2.fwd_build(CB, TS)["ppt"] == ppt
    c = r2._fwd_2dgs_counts(b.S, b.starts, masks, cfg)
    want, tot, n_warps = _walk(b.S, b.starts, masks, cfg, ppt)
    for k in ("run", "pairs", "slots"):
        assert c[k].tolist() == want[k], k
    for k in tot:
        assert c[k] == tot[k], k
    assert c["warps_per_tile"] == n_warps == (1 if ppt == 2 else 2)
    assert int(c["slots"].sum()) > 300
    assert c["missed_slots"] == 0
    assert c["candidate_slots"] < c["evaluated_slots"] // 2
    assert c["pair_warp_hits"] <= c["pair_warp_candidates"]
    # the boxes hold the regions whole: the warps' box test loses no
    # candidate, and skips some (pair, warp)
    assert c["candidate_slots"] == r2._region_counts_2dgs(
        b.S, b.starts, masks, cfg, ppt)["candidate_slots"]
    assert c["pair_warp_candidates"] <= c["pair_warp_cells"] < (
        n_warps * int(c["run"].sum()))
    _, fc = r2._fwd_2dgs_plain(b.S, b.starts, masks, cfg, CB - 4,
                               with_counts=True)
    assert fc["composited"] == int(c["slots"].sum())


SMALL = r2.FWD_SMALL_MIN_BLOCKS


@pytest.mark.parametrize("channels,tile_size,want", [
    (7, 16, (8, 2, 128, 128, SMALL)),  # train_1m_2dgs: 4 warps of 8 x 8
    (4, 8, (4, 2, 32, 128, SMALL)),
    (7, 32, (8, 2, 512, 512, 1)),  # tile 32: 512 threads, not 1024
    (16, 16, (16, 2, 128, 512, 1)),  # no small build above bound 8
    (32, 32, (32, 2, 512, 512, 1)),
    (40, 16, (64, 1, 256, 256, 1)),  # 1 pixel a thread above 32
    (40, 32, (64, 1, 1024, 1024, 1)),  # the tile-32 wide build
    (128, 8, (128, 1, 64, 256, 1)),
    (128, 32, (128, 1, 1024, 1024, 1)),
])
def test_fwd_build(channels, tile_size, want):
    b = r2.fwd_build(channels, tile_size)
    assert (b["cbm"], b["ppt"], b["threads"], b["max_threads"],
            b["min_blocks"]) == want
