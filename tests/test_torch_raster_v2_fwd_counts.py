"""raster_v2._fwd_counts, the count of what the 3DGS tile forward (B1)
evaluates, against a pair-by-pair walk of B1's layout written out here,
in both cutoffs and in the product and the log-space scan; and
raster_v2.fwd_build, the build that a launch takes, case by case.

B1's layout (csrc/raster_fwd.cu): 2 pixels a lane at up to 32 channels (a
warp's 32 lanes an 8 x 8 pixel cell), or 1 (8 x 4) above 32 channels and
in the build for dense tiles (raster_v2.bwd_dense), the cells row-major.
A warp evaluates a pair where its cell meets the pair's box, and a pixel
is a candidate where its float sigma lies within the pair's bound
(raster_v2._pair_regions, B2's regions).

The walk takes the plain tile walk's transmittance: a chunk's T_prev as
the running product of its 1 - alpha from the chunk's start (the product
scan) or T * exp(s1 + s2 - l) with the running sums of the two bf16 halves
of l = log1p(-alpha) (the log scan); the exact cutoff ends a pixel's
chunk before the first pair whose inclusive T falls to 1e-4 or below, and
the soft cutoff ends the tile when every pixel has T <= 1e-4 at a chunk's
start.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as rv

K = rv.K


def _scene(seed, N, W=40, H=24):
    """Seeded Gaussians over a 40 x 24 image (tiles of 8: a 5 x 3 grid),
    some large and opaque enough for the exact cutoff: 150 take B1's dense
    build (10 a tile), 1200 the other."""
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


def _walk(S, starts, masks, cfg, ppt):
    """The counts of _fwd_counts, pair by pair and pixel by pixel, in the
    layout of ``ppt`` pixels a lane."""
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
                         "missed_slots", "pair_warp_walked", "box",
                         "pair_warp_candidates", "pair_warp_hits",
                         "single_lane_hits"), 0)
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
            s1, s2 = torch.zeros(P), torch.zeros(P)
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
                if cfg.log_composite:
                    _, l1, l2 = rv._log_split(alpha)
                    s1, s2 = s1 + l1, s2 + l2
                    t_incl = T0 * torch.exp(s1 + s2)
                else:
                    t_incl = excl * T0 * (1.0 - alpha)
                    excl = excl * (1.0 - alpha)
                if cfg.cutoff == "exact":
                    live &= t_incl > rv.TRANSMITTANCE_EPS
                    comp = valid & live
                    T = torch.where(live, t_incl, T)
                else:
                    comp = valid
                    T = t_incl
                rx, ry, lm, _ = (float(v) for v in rv._pair_regions(
                    [x, y, ca, cb, cc, op]))
                ex = x - torch.minimum(torch.maximum(x, cells[0]), cells[1])
                ey = y - torch.minimum(torch.maximum(y, cells[2]), cells[3])
                box = (ex.abs() <= rx) & (ey.abs() <= ry)
                cand = box[warp] & (sigma <= lm)
                out["run"][t] += 1
                out["pairs"][t] += int(comp.any())
                out["slots"][t] += int(comp.sum())
                tot["evaluated_slots"] += P
                tot["candidate_slots"] += int(cand.sum())
                tot["missed_slots"] += int((valid & ~cand).sum())
                tot["pair_warp_walked"] += n_warps
                tot["box"] += int(box.sum())
                for w in range(n_warps):
                    tot["pair_warp_candidates"] += int(cand[warp == w].any())
                    lanes = {int(v) for v in lane[(warp == w) & comp]}
                    tot["pair_warp_hits"] += int(len(lanes) > 0)
                    tot["single_lane_hits"] += int(len(lanes) == 1)
            if cfg.cutoff == "soft" and not cfg.log_composite:
                T = excl * T0  # the plain walk's product at the chunk end
    return out, tot, n_warps


@pytest.mark.parametrize("N", [150, 1200])
@pytest.mark.parametrize("log_composite", [False, True])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_fwd_counts_match_pair_walk(cutoff, log_composite, N):
    f, radii = _scene(0, N)
    cfg = rv.V2Cfg(C=1, tile_width=5, tile_height=3, tile_size=8,
                   channels=3, cap=rv.CAP_BLOCK, n=f[0].shape[1],
                   cutoff=cutoff, log_composite=log_composite)
    b = rv._build_sorted(cfg, *f, radii)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    masks[4] = 0
    dense = N == 150
    assert rv.bwd_dense(cfg) == dense
    ppt = 1 if dense else 2  # the dense build's 8 x 4 cells, else 8 x 8
    assert rv.fwd_build(cfg.channels, 8, dense=dense)["ppt"] == ppt
    c = rv._fwd_counts(b.S, b.starts, masks, cfg)
    want, tot, n_warps = _walk(b.S, b.starts, masks, cfg, ppt)
    for k in ("run", "pairs", "slots"):
        assert c[k].tolist() == want[k], k
    for k in ("evaluated_slots", "candidate_slots", "missed_slots",
              "pair_warp_walked", "pair_warp_candidates", "pair_warp_hits",
              "single_lane_hits"):
        assert c[k] == tot[k], k
    assert c["pair_warp_cells"]["box"] == tot["box"]
    assert c["warps_per_tile"] == n_warps == (2 if dense else 1)
    # the scene composites many slots, the regions skip most walked ones,
    # and none that passes lies outside them
    assert int(c["slots"].sum()) > 300
    assert c["missed_slots"] == 0
    assert c["candidate_slots"] < c["evaluated_slots"] // 2
    # the composited slots are the plain forward's own count
    _, fc = rv._fwd_plain(b.S, b.starts, masks, cfg, with_counts=True)
    assert fc["composited"] == int(c["slots"].sum())


SMALL = rv.FWD_SMALL_MIN_BLOCKS


@pytest.mark.parametrize("channels,tile_size,dense,want", [
    (3, 16, False, (3, 2, 128, 128, SMALL)),  # train_1m: 4 warps of 8 x 8
    (3, 16, True, (3, 1, 256, 256, 1)),  # the dense views: 8 warps of 8 x 4
    (3, 32, False, (3, 2, 512, 512, 1)),  # bench_1m: 512 threads, not 1024
    (3, 32, True, (3, 2, 512, 512, 1)),  # 1024 threads at 1: no dense build
    (1, 8, False, (3, 2, 32, 128, SMALL)),
    (4, 8, True, (8, 1, 64, 256, 1)),
    (8, 16, False, (8, 2, 128, 128, SMALL)),
    (16, 16, True, (16, 2, 128, 512, 1)),  # dense only at bounds 3 and 8
    (32, 32, False, (32, 2, 512, 512, 1)),
    (40, 16, False, (64, 1, 256, 256, 1)),  # 1 pixel a thread above 32
    (40, 32, False, (64, 1, 1024, 1024, 1)),  # the tile-32 wide build
    (128, 16, False, (128, 1, 256, 256, 1)),
    (128, 32, False, (128, 1, 1024, 1024, 1)),
    (12, 12, False, (16, 2, 128, 512, 1)),  # a partial cell column and row
])
def test_fwd_build(channels, tile_size, dense, want):
    b = rv.fwd_build(channels, tile_size, dense=dense)
    assert (b["chm"], b["ppt"], b["threads"], b["max_threads"],
            b["min_blocks"]) == want
    assert b["threads"] <= b["max_threads"]
    # the block covers the tile: warps of 8-wide cells, 32 / (8 / ppt) rows
    rows = 32 // (8 // b["ppt"])
    assert b["threads"] == 32 * -(-tile_size // 8) * -(-tile_size // rows)


@pytest.mark.parametrize("grad", [False, True])
def test_tile_order_only_where_a_backward_follows(monkeypatch, grad):
    """rasterize_to_pixels_v2 makes the longest-run-first tile order (one
    argsort a binning, for B1 and B2) only where autograd records the
    render; a render with no backward leaves B1 in index order."""
    f, radii = _scene(1, 150)
    made = []
    run_order = rv.run_order

    def counted(starts, cfg):
        made.append(cfg.n_tiles)
        return run_order(starts, cfg)

    monkeypatch.setattr(rv, "run_order", counted)
    m2 = f[0].clone().requires_grad_(True)
    with torch.set_grad_enabled(grad):
        img, _, _ = rv.rasterize_to_pixels_v2(
            m2, *f[1:], radii, 40, 24, tile_size=8,
            isect_capacity=rv.CAP_BLOCK, device="cpu")
    assert made == ([15] if grad else [])
    if grad:
        img.sum().backward()
        assert made == [15]  # the backward reads the forward's order
        assert bool(torch.isfinite(m2.grad).all())
