"""raster_v2._bwd_counts, the count of what the 3DGS tile backward (B2)
evaluates and sums over a tile's pixels, against a pair-by-pair walk of
B2's layout written out here; and the candidate regions (_pair_regions)
inside which B2 evaluates a pair, which must hold every pixel that passes
the alpha test, on seeded random conics (near-degenerate ones, opacities
just above 1/255, bf16 and u16 values among them).

The walk takes the plain tile walk's transmittance (a chunk's T_prev as
the running product of its 1 - alpha from the chunk's start, the tile
stopping when every pixel has T <= 1e-4 at a chunk's start) and B2's
layout: 2 pixels a lane at up to 32 channels (a warp's 32 lanes an 8 x 8
pixel cell), or 1 (8 x 4) in the build for dense tiles, the cells
row-major.
"""

import math

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as rv

K = rv.K


def _scene(seed, N=150, W=40, H=24):
    """Seeded Gaussians over a 40 x 24 image (tiles of 8: a 5 x 3 grid),
    some large and opaque enough for the exact cutoff: 150 take B2's dense
    build (10 a tile, two 8 x 4 warps a tile), 1200 the other (one 8 x 8
    warp)."""
    rng = np.random.default_rng(seed)
    m2 = np.stack([rng.random(N) * W, rng.random(N) * H], -1)
    L = rng.random((N, 2, 2)) - 0.5
    cov = 12.0 * (L @ np.swapaxes(L, -1, -2)) + 1.0 * np.eye(2)
    con = np.linalg.inv(cov)
    conics = np.stack([con[:, 0, 0], con[:, 0, 1], con[:, 1, 1]], -1)
    op = np.where(rng.random(N) < 0.5, 0.99, rng.random(N))
    col = rng.random((N, 3))
    dep = rng.random(N) + 1.0
    radii = np.full((N, 2), 6, np.int32)
    f = [torch.tensor(x[None], dtype=torch.float32)
         for x in (m2, conics, col, op, dep)]
    return f, torch.tensor(radii[None])


def _walk(S, starts, masks, cfg):
    """The counts of _bwd_counts, pair by pair and pixel by pixel."""
    ts, P = cfg.tile_size, cfg.pixels
    ppt = rv.bwd_build(cfg.channels, ts, dense=rv.bwd_dense(cfg))["ppt"]
    ct, rc = 8 // ppt, 32 // (8 // ppt)
    cells_x = -(-ts // 8)
    n_warps = cells_x * -(-ts // rc)
    p = torch.arange(P)
    row, col = p // ts, p % ts
    warp = (row // rc) * cells_x + col // 8
    lane = (row % rc) * ct + (col % 8) // ppt
    out = {k: [0] * cfg.n_tiles for k in ("run", "pairs", "slots")}
    tot = dict.fromkeys(("evaluated_slots", "candidate_slots",
                         "missed_slots", "pair_warp_walked",
                         "pair_warp_candidates", "pair_warp_hits",
                         "single_lane_hits", "box", "disc", "both"), 0)
    for t in range(cfg.n_tiles):
        off, end = int(starts[t]), int(starts[t + 1])
        if end <= off or not masks[t]:
            continue
        tx, ty = t % cfg.tile_width, t // cfg.tile_width
        px = (tx * ts + col).float() + 0.5
        py = (ty * ts + row).float() + 0.5
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
            excl = torch.ones(P)
            live = torch.ones(P, dtype=torch.bool)
            T0 = T.clone()
            for j in range(max(off, c * K), min(end, (c + 1) * K)):
                x, y, ca, cb, cc, op = (S[r, j:j + 1] for r in range(6))
                dx, dy = x - px, y - py
                sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
                         + cb * (dx * dy))
                alpha = torch.clamp(op * torch.exp(-sigma), max=rv.MAX_ALPHA)
                valid = (sigma >= 0.0) & (alpha >= rv.ALPHA_THRESHOLD)
                alpha = torch.where(valid, alpha, torch.zeros(()))
                t_incl = excl * (1.0 - alpha) * T0
                if cfg.cutoff == "exact":
                    live &= t_incl > rv.TRANSMITTANCE_EPS
                    comp = valid & live
                    T = torch.where(live, t_incl, T)
                else:
                    comp = valid
                    T = t_incl
                excl = excl * (1.0 - alpha)
                rx, ry, lm, rd = (float(v) for v in rv._pair_regions(
                    [x, y, ca, cb, cc, op]))
                ex = x - torch.minimum(torch.maximum(x, cells[0]), cells[1])
                ey = y - torch.minimum(torch.maximum(y, cells[2]), cells[3])
                box = (ex.abs() <= rx) & (ey.abs() <= ry)
                disc = ex * ex + ey * ey <= rd * rd
                cand = box[warp] & (sigma <= lm)
                out["run"][t] += 1
                out["pairs"][t] += int(comp.any())
                out["slots"][t] += int(comp.sum())
                tot["evaluated_slots"] += P
                tot["candidate_slots"] += int(cand.sum())
                tot["missed_slots"] += int((valid & ~cand).sum())
                tot["pair_warp_walked"] += n_warps
                tot["box"] += int(box.sum())
                tot["disc"] += int(disc.sum())
                tot["both"] += int((box & disc).sum())
                for w in range(n_warps):
                    tot["pair_warp_candidates"] += int(cand[warp == w].any())
                    lanes = {int(v) for v in lane[(warp == w) & comp]}
                    tot["pair_warp_hits"] += int(len(lanes) > 0)
                    tot["single_lane_hits"] += int(len(lanes) == 1)
            if cfg.cutoff == "soft":
                T = excl * T0
    return out, tot, n_warps


@pytest.mark.parametrize("N", [150, 1200])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_bwd_counts_match_pair_walk(cutoff, N):
    f, radii = _scene(0, N)
    cfg = rv.V2Cfg(C=1, tile_width=5, tile_height=3, tile_size=8,
                   channels=3, cap=rv.CAP_BLOCK, n=f[0].shape[1],
                   cutoff=cutoff)
    b = rv._build_sorted(cfg, *f, radii)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    masks[4] = 0
    c = rv._bwd_counts(b.S, b.starts, masks, cfg)
    want, tot, n_warps = _walk(b.S, b.starts, masks, cfg)
    for k in ("run", "pairs", "slots"):
        assert c[k].tolist() == want[k], k
    for k in ("evaluated_slots", "candidate_slots", "missed_slots",
              "pair_warp_walked", "pair_warp_candidates", "pair_warp_hits",
              "single_lane_hits"):
        assert c[k] == tot[k], k
    assert c["pair_warp_cells"] == dict(box=tot["box"], disc=tot["disc"],
                                        box_and_disc=tot["both"])
    assert c["warps_per_tile"] == n_warps == (2 if N == 150 else 1)
    assert rv.bwd_dense(cfg) == (N == 150)
    # the scene composites many slots, the regions skip most walked ones,
    # and none that passes lies outside them
    assert int(c["slots"].sum()) > 300
    assert c["missed_slots"] == 0
    assert c["candidate_slots"] < c["evaluated_slots"] // 2
    if cutoff == "exact":  # the cutoff ends some pixels early
        _, fc = rv._fwd_plain(b.S, b.starts, masks, cfg, with_counts=True)
        assert fc["tested"] > fc["composited"]


def _conics(rng, n):
    """Seeded conics, rotated and elongated up to an axis ratio of ~400:
    well-conditioned ones, and near-degenerate ones on both sides of
    det A = BWD_COND ca cc; centres anywhere in a pixel."""
    theta = rng.random(n) * np.pi
    la = np.exp(rng.uniform(-3.0, 1.0, n))
    lb = la * np.exp(rng.uniform(-12.0, 0.0, n))
    c, s = np.cos(theta), np.sin(theta)
    ca = la * c * c + lb * s * s
    cc = la * s * s + lb * c * c
    cb = (la - lb) * c * s
    x = rng.uniform(20.0, 21.0, n)
    y = rng.uniform(20.0, 21.0, n)
    op = np.where(rng.random(n) < 0.3,
                  1.0 / 255.0 * (1.0 + rng.uniform(0.0, 1e-3, n)),
                  rng.uniform(0.004, 1.0, n))
    return [torch.tensor(v, dtype=torch.float32)
            for v in (x, y, ca, cb, cc, op)]


@pytest.mark.parametrize("rows", ["f32", "bf16", "u16"])
def test_regions_hold_every_passing_pixel(rows):
    rng = np.random.default_rng({"f32": 0, "bf16": 1, "u16": 2}[rows])
    geo = _conics(rng, 3000)
    if rows == "bf16":  # the pairs' truncated values, as B2 reads them
        hi, lo = rv.unpack_pairs(rv.pack_pairs(geo[2], geo[3]))
        hi2, lo2 = rv.unpack_pairs(rv.pack_pairs(geo[4], geo[5]))
        geo = geo[:2] + [hi, lo, hi2, lo2]
    if rows == "u16":
        geo = list(rv.unpack_u16_xy(rv.pack_u16_xy(geo[0], geo[1]))) + \
            geo[2:]
    rx, ry, lm, _ = rv._pair_regions(geo)
    # pixel centres within 160 px of the centres
    g = torch.arange(-140, 181, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(g, g, indexing="ij")
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    x, y, ca, cb, cc, op = geo
    dx, dy = x - px, y - py
    sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
             + cb * (dx * dy))
    alpha = torch.clamp(op * torch.exp(-sigma), max=rv.MAX_ALPHA)
    valid = (sigma >= 0.0) & (alpha >= rv.ALPHA_THRESHOLD)
    inside = (dx.abs() <= rx) & (dy.abs() <= ry) & (sigma <= lm)
    assert int(valid.sum()) > 10_000
    assert not bool((valid & ~inside).any())
    # the conics past the conditioning limit get no bound; the rest one
    ca64, cb64, cc64 = (v.double() for v in (ca, cb, cc))
    ill = ca64 * cc64 - cb64 * cb64 < rv.BWD_COND * ca64 * cc64
    assert 0 < int(ill.sum()) < len(ill) // 2
    faint = ~(op >= rv.ALPHA_THRESHOLD)
    assert bool(torch.isinf(rx[ill & ~faint]).all())
    assert bool(torch.isfinite(rx[~ill]).all())
    assert bool((rx[faint] == -1.0).all())
    # and the bounded ones stay tight: the (pair, pixel) slots inside them
    # within 10% of those that pass
    bounded = torch.isfinite(rx) & (rx > 0)
    assert int(inside[:, bounded].sum()) <= 1.1 * int(valid[:, bounded].sum())


def test_regions_of_faint_and_bad_pairs():
    """op below 1/255 gives an empty region, a conic that is not positive
    definite (or NaN) no bound."""
    geo = [torch.tensor(v, dtype=torch.float32) for v in (
        [0.5, 0.5, 0.5, 0.5], [0.5, 0.5, 0.5, 0.5],
        [1.0, 1.0, -1.0, float("nan")], [0.0, 2.0, 0.0, 0.0],
        [1.0, 1.0, 1.0, 1.0], [0.5 / 255.0, 0.9, 0.9, 0.9])]
    rx, ry, lm, _ = rv._pair_regions(geo)
    assert rx[0] == ry[0] == lm[0] == -1.0
    for i in (1, 2, 3):
        assert math.isinf(rx[i]) and math.isinf(ry[i]) and math.isinf(lm[i])


@pytest.mark.parametrize("channels,tile_size,dense,want", [
    (3, 16, False, (3, 2, 128, 8, 64)),  # train_1m: 128 threads
    (3, 16, True, (3, 1, 256, 4, 64)),  # the trained views: 256 threads
    (3, 32, False, (3, 2, 512, 2, 64)),  # bench_1m: 512 threads
    (3, 32, True, (3, 2, 512, 2, 64)),  # 1024 threads at 1: no dense build
    (1, 8, False, (3, 2, 128, 8, 64)),
    (8, 16, False, (8, 2, 128, 8, 64)),
    (16, 16, True, (16, 2, 512, 1, 128)),
    (40, 16, False, (64, 1, 256, 1, 64)),  # 8 warps: 64 pairs fit
    (128, 32, False, (128, 1, 1024, 1, 4)),  # shared memory halves them
])
def test_bwd_build(channels, tile_size, dense, want):
    b = rv.bwd_build(channels, tile_size, dense=dense)
    assert (b["chm"], b["ppt"], b["max_threads"], b["min_blocks"],
            b["sub"]) == want
