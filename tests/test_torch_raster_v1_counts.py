"""rasterize_pallas._region_counts, the count of what the legacy v1 tile
kernels (B7 and B8) evaluate and sum over a tile's pixels, against a
pair-by-pair walk of their layout written out here; and the candidate
regions (raster_v2._pair_regions, which B7 and B8 share with B1 and B2),
which must hold every pixel that passes the alpha test. No JAX: the
inputs go through the port's own v1 binning (ops/isect.py).

The walk keeps v1's semantics: the tile's stop vote before each chunk
over all of its pixels (those past the image's edge too), the exact
cutoff's stop at a pixel's first valid pair that fails and its restart at
the next chunk, the plain walk's transmittance (a chunk's T_prev the
running product of its 1 - alpha from the chunk's start, times the T it
started from); and B7's and B8's layout: 2 pixels a lane up to 32 channels
(a warp's 32 lanes an 8 x 8 pixel cell), 1 above (8 x 4), the cells
row-major.

The scenes are made to press on the regions: large opaque Gaussians under
everything (the exact cutoff and the tile's stop, runs of more than one
chunk), conics up to an axis ratio of ~400 on both sides of the
conditioning limit (raster_v2.BWD_COND), opacities just above 1/255, and
Gaussians placed so that a warp cell's edge of pixel centres lies on the
edge of their box.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import isect as ti
from gscodec_studio_tpu_torch.ops import raster_v2 as rv
from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp

K = rp.K_CHUNK
W, H = 48, 32


def _conics(rng, n):
    """Rotated conics elongated up to an axis ratio of ~400, on both sides
    of det A = BWD_COND ca cc: (ca, cb, cc)."""
    theta = rng.random(n) * np.pi
    la = np.exp(rng.uniform(-3.0, 0.0, n))
    lb = la * np.exp(rng.uniform(-12.0, 0.0, n))
    c, s = np.cos(theta), np.sin(theta)
    return (la * c * c + lb * s * s, (la - lb) * c * s,
            la * s * s + lb * c * c)


def _scene(seed, ts, cutoff, CH):
    """The aligned v1 table of a seeded scene over a W x H image: (packed,
    starts, ends, cfg)."""
    rng = np.random.default_rng(seed)
    n_cover, n_thin, n_edge = 70, 50, 30
    # opaque round Gaussians under everything
    cx = rng.uniform(0.0, W, n_cover)
    cy = rng.uniform(0.0, H, n_cover)
    s2 = rng.uniform(6.0, 60.0, n_cover)
    cover = [cx, cy, 1.0 / s2, np.zeros(n_cover), 1.0 / s2,
             np.full(n_cover, 0.99)]
    # near-degenerate conics, a third of them barely visible
    ca, cb, cc = _conics(rng, n_thin)
    faint = 1.0 / 255.0 * (1.0 + rng.uniform(0.0, 1e-3, n_thin))
    op = np.where(rng.random(n_thin) < 0.35, faint,
                  rng.uniform(0.004, 1.0, n_thin))
    thin = [rng.uniform(0.0, W, n_thin), rng.uniform(0.0, H, n_thin), ca,
            cb, cc, op]
    # moderate conics whose box edge lies on a cell edge of pixel centres
    # (the cells' edges are at 8m + 0.5 and 8m + 7.5 in x and y)
    ea, eb, ec = _conics(rng, n_edge)
    ea, ec = ea + 0.05, ec + 0.05
    eop = np.where(rng.random(n_edge) < 0.5,
                   1.0 / 255.0 * (1.0 + rng.uniform(0.0, 1e-3, n_edge)),
                   rng.uniform(0.05, 1.0, n_edge))
    geo = [torch.tensor(v, dtype=torch.float32)
           for v in (np.zeros(n_edge), np.zeros(n_edge), ea, eb, ec, eop)]
    rx, ry, _, _ = rv._pair_regions(geo)
    rx, ry = rx.numpy(), ry.numpy()
    mx = 8.0 * rng.integers(0, W // 8, n_edge)
    my = 8.0 * rng.integers(0, H // 8, n_edge)
    left = rng.random(n_edge) < 0.5
    top = rng.random(n_edge) < 0.5
    ex = np.where(left, mx + 0.5 - rx, mx + 7.5 + rx).astype(np.float32)
    ey = np.where(top, my + 0.5 - ry, my + 7.5 + ry).astype(np.float32)
    edge = [ex, ey, ea, eb, ec, eop]
    g = [np.concatenate([a, b, c]).astype(np.float32)
         for a, b, c in zip(cover, thin, edge)]
    N = len(g[0])
    # scalar radii: three standard deviations along the long axis, at most
    # the image
    cov_max = np.linalg.eigvalsh(np.linalg.inv(np.stack(
        [np.stack([g[2], g[3]], -1), np.stack([g[3], g[4]], -1)],
        -2).astype(np.float64)))[:, -1]
    radii = np.ceil(np.minimum(3.0 * np.sqrt(np.abs(cov_max)), W))
    depths = rng.permutation(N).astype(np.float32) + 1.0
    colors = rng.random((N, CH)).astype(np.float32)
    TW, TH = -(-W // ts), -(-H // ts)
    cap = 1 << 14
    means = torch.tensor(np.stack(g[:2], -1)[None])
    isect = ti.isect_tiles(means, torch.tensor(radii[None], dtype=torch.int32),
                           torch.tensor(depths[None]), ts, TW, TH, cap)
    al = ti.align_isects(isect, 1, TW, TH, K, need_inv_perm=False)
    cfg = rp.RasterCfg(C=1, tile_width=TW, tile_height=TH, tile_size=ts,
                       channels=CH, cap=cap, cap2=al.ids.shape[0], m=N,
                       cutoff=cutoff)
    flat = torch.tensor(np.concatenate(
        [np.stack(g, -1), colors], -1)).contiguous()
    return rp._pack(flat, al.ids), al.starts, al.ends, cfg


def _walk(packed, starts, ends, cfg):
    """The counts of _region_counts, pair by pair."""
    ts, P = cfg.tile_size, cfg.pixels
    ppt = rv.bwd_pixels_per_thread(cfg.channels)
    ct, rc = 8 // ppt, 32 // (8 // ppt)
    cells_x = -(-ts // 8)
    n_warps = cells_x * -(-ts // rc)
    p = torch.arange(P)
    row, col = p // ts, p % ts
    warp = (row // rc) * cells_x + col // 8
    lane = (row % rc) * ct + (col % 8) // ppt
    eps = rp.TRANSMITTANCE_EPS
    out = {k: [0] * cfg.n_tiles for k in ("run", "pairs", "slots")}
    tot = dict.fromkeys((
        "evaluated_slots", "candidate_slots", "missed_slots", "tested",
        "composited", "pair_warp_walked", "pair_warp_cells",
        "pair_warp_candidates", "pair_warp_hits", "single_lane_hits"), 0)
    for t in range(cfg.n_tiles):
        start, end = int(starts[t]), int(ends[t])
        tx, ty = t % cfg.tile_width, t // cfg.tile_width
        px = (tx * ts + col).float() + 0.5
        py = (ty * ts + row).float() + 0.5
        wx = torch.arange(n_warps) % cells_x
        wy = torch.arange(n_warps) // cells_x
        cells = [(v + 0.5).float() for v in (
            tx * ts + wx * 8, tx * ts + torch.clamp(wx * 8 + 7, max=ts - 1),
            ty * ts + wy * rc, ty * ts + torch.clamp(wy * rc + rc - 1,
                                                    max=ts - 1))]
        T = torch.ones(P)
        for row0 in range(start, end, K):
            if not bool((T > eps).any()):  # the tile's stop vote
                break
            excl = torch.ones(P)
            live = torch.ones(P, dtype=torch.bool)  # before the cutoff
            t_min = T.clone()
            # the chunk's rows, then its padding rows (alpha 0) as one
            for j in range(row0, min(end, row0 + K) + (end < row0 + K)):
                if j < end:
                    x, y, ca, cb, cc, op = (packed[j, r:r + 1]
                                            for r in range(6))
                    dx, dy = x - px, y - py
                    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) \
                        + cb * dx * dy
                    alpha = torch.clamp(op * torch.exp(-sigma),
                                        max=rp.MAX_ALPHA)
                    valid = (sigma >= 0.0) & (alpha >= rp.ALPHA_THRESHOLD)
                    alpha = torch.where(valid, alpha, torch.zeros(()))
                else:
                    valid = torch.zeros(P, dtype=torch.bool)
                    alpha = torch.zeros(P)
                t_incl = (excl * T) * (1.0 - alpha)
                excl = excl * (1.0 - alpha)
                if cfg.cutoff == "exact":
                    # the slots up to the first valid pair that fails
                    seen = live.clone()
                    ok = t_incl > eps
                    comp = valid & ok
                    live &= ~(valid & ~ok)
                    t_min = torch.where(ok, torch.minimum(t_min, t_incl),
                                        t_min)
                else:
                    seen = torch.ones(P, dtype=torch.bool)
                    comp = valid
                    t_min = t_incl
                if j >= end:
                    continue
                rx, ry, lm, _ = (float(v) for v in rv._pair_regions(
                    [x, y, ca, cb, cc, op]))
                ex = x - torch.minimum(torch.maximum(x, cells[0]), cells[1])
                ey = y - torch.minimum(torch.maximum(y, cells[2]), cells[3])
                box = (ex.abs() <= rx) & (ey.abs() <= ry)
                region = box[warp] & (sigma <= lm)
                cand = region & seen
                out["run"][t] += 1
                out["pairs"][t] += int(comp.any())
                out["slots"][t] += int(comp.sum())
                tot["evaluated_slots"] += int(seen.sum())
                tot["candidate_slots"] += int(cand.sum())
                tot["missed_slots"] += int((valid & ~region).sum())
                tot["tested"] += int((valid & seen).sum())
                tot["composited"] += int(comp.sum())
                tot["pair_warp_walked"] += n_warps
                tot["pair_warp_cells"] += int(box.sum())
                has_cand = torch.zeros(n_warps, dtype=torch.bool)
                has_cand[warp[cand]] = True
                hit = torch.zeros((n_warps, 32), dtype=torch.bool)
                hit[warp[comp], lane[comp]] = True
                tot["pair_warp_candidates"] += int(has_cand.sum())
                tot["pair_warp_hits"] += int(hit.any(1).sum())
                tot["single_lane_hits"] += int((hit.sum(1) == 1).sum())
            T = t_min
    return out, tot, n_warps


@pytest.mark.parametrize("CH", [3, 64])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
@pytest.mark.parametrize("ts", [16, 32])
def test_region_counts_match_pair_walk(ts, cutoff, CH):
    packed, starts, ends, cfg = _scene(ts + CH, ts, cutoff, CH)
    c = rp._region_counts(packed, starts, ends, cfg)
    want, tot, n_warps = _walk(packed, starts, ends, cfg)
    for k in ("run", "pairs", "slots"):
        assert c[k].tolist() == want[k], k
    for k, v in tot.items():
        assert c[k] == v, k
    assert c["warps_per_tile"] == n_warps
    assert c["longest_run"] == max(want["run"])
    assert want["run"][c["longest_tile"]] == c["longest_run"]
    # the plain walk's own counts of the same slots
    _, _, pc = rp._fwd_plain(packed, starts, ends, cfg, with_counts=True)
    assert (pc["evaluated"], pc["tested"], pc["composited"]) == (
        c["evaluated_slots"], c["tested"], c["composited"])
    # the scene composites many slots, the regions skip most walked slots,
    # and none that passes lies outside them
    assert c["composited"] > 2000
    assert c["missed_slots"] == 0
    assert c["candidate_slots"] < c["evaluated_slots"] // 2
    if cutoff == "exact":  # the cutoff ends some pixels early and restarts
        assert c["tested"] > c["composited"]
        assert c["longest_run"] > K
    else:  # a tile stops before its run's end, or walks a second chunk
        assert sum(want["run"]) < int((ends - starts).sum()) \
            or c["longest_run"] > K
