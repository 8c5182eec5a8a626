"""gscodec_studio_tpu_torch.ops.raster_v2 (plain PyTorch versions of the
pack, expansion and tile-forward kernels) vs the JAX package's Pallas
pipeline run in interpret mode on the CPU, on the same numpy inputs.

Tolerances:
  * pack, the sorted table S and starts: exact. The only allowed
    difference is a pair on the expansion's ellipse-cull bound, where a
    1-ulp difference of `log` moves the pair between its tile and the
    overflow tile; such a pair has alpha < 1/255 in every pixel of the
    tile, and the check names it.
  * images and alphas: max abs <= 5e-3 and >= 99.9% of values within 1e-4
    (transmittance products and color sums are taken in another order, and
    an `exp` ulp can flip a pair at alpha ~ 1/255 or T ~ 1e-4); n_isects
    equal.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import raster_v2 as jr
from gscodec_studio_tpu_torch.ops import raster_v2 as tr

from tests.test_rasterize_pallas import make_2d_scene


def assert_images_close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    d = np.abs(port - ref)
    assert d.max() <= 5e-3, d.max()
    assert (d <= 1e-4).mean() >= 0.999, (d > 1e-4).mean()


def assert_same_sorted(S_t, starts_t, S_j, starts_j, cfg):
    """S and starts equal, apart from named pairs on the cull bound."""
    S_t, starts_t = S_t.numpy(), starts_t.numpy()
    S_j, starts_j = np.asarray(S_j), np.asarray(starts_j)
    assert not S_j[cfg.d_s:].any()  # the JAX layout's zero padding rows
    S_j = S_j[:cfg.d_s]
    if np.array_equal(S_t, S_j) and np.array_equal(starts_t, starts_j):
        return

    def pairs(S, starts):
        n = int(starts[-1])
        tiles = np.searchsorted(starts, np.arange(n), side="right") - 1
        return {(int(t), int(g)): S[:, j] for j, (t, g) in
                enumerate(zip(tiles, S[cfg.d_s - 1, :n]))}

    pt, pj = pairs(S_t, starts_t), pairs(S_j, starts_j)
    for key in pt.keys() & pj.keys():
        np.testing.assert_array_equal(pt[key], pj[key])
    moved = [k for k in pt.keys() ^ pj.keys() if k[0] < cfg.n_tiles]
    for t, g in moved:
        assert (cfg.n_tiles, g) in (pt.keys() ^ pj.keys())
    if moved:
        cols = np.stack([(pt.get(k) if k in pt else pj[k]) for k in moved], 1)
        lhs, rhs = tr._cull_lhs_rhs(
            cfg, torch.tensor([t for t, _ in moved], dtype=torch.int32),
            torch.as_tensor(cols[:6]), torch.arange(len(moved)))
        assert bool(((lhs - rhs).abs()
                     <= 1e-5 * torch.clamp(rhs.abs(), min=1.0)).all())
        warnings.warn(f"pairs on the ellipse-cull bound: {moved}")
    # outside the moved pairs every tile's run holds the same ids in order
    for t in range(cfg.n_tiles):
        ids = lambda S, st: [g for g in S[cfg.d_s - 1, st[t]:st[t + 1]]
                             if (t, int(g)) not in moved]
        assert ids(S_t, starts_t) == ids(S_j, starts_j)


def _cfgs(C, N, W, H, ts, CH, cap):
    TW, TH = -(-W // ts), -(-H // ts)
    cj = jr.V2Cfg(C=C, tile_width=TW, tile_height=TH, tile_size=ts,
                  channels=CH, cap=cap, n=N, tiles_per_step=4,
                  interpret=True, absgrad=False)
    ct = tr.V2Cfg(C=C, tile_width=TW, tile_height=TH, tile_size=ts,
                  channels=CH, cap=cap, n=N)
    return cj, ct


def _elliptical(rng, radii):
    ry = np.maximum(radii - rng.integers(0, 4, radii.shape), 0)
    return np.stack([radii, ry], -1).astype(np.int32)


def test_pack_rows_matches_jax(rng):
    L = 4096
    rows = [rng.standard_normal(L).astype(np.float32) for _ in range(5)]
    perm = rng.permutation(L)
    ref = jr.pack_rows([jnp.asarray(r) for r in rows], 8, interpret=True)
    ref_perm = jr.pack_rows([jnp.asarray(r[perm]) for r in rows], 8,
                            interpret=True)
    trows = [torch.as_tensor(r) for r in rows]
    np.testing.assert_array_equal(tr.pack_rows(trows, 8).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(
        tr.pack_rows(trows, 8, torch.as_tensor(perm)).numpy(),
        np.asarray(ref_perm))
    # strided rows (views of an interleaved array) pack the same way
    inter = torch.as_tensor(np.stack(rows, 1).copy())
    np.testing.assert_array_equal(
        tr.pack_rows(list(inter.unbind(1)), 8).numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "C,N,ts,CH,ell,cap",
    [(2, 600, 16, 3, True, 8192), (1, 500, 32, 1, False, 8192),
     (2, 1500, 16, 3, True, 4096)],
    ids=["ts16-ell", "ts32-scalar", "total-over-cap"],
)
def test_build_sorted_matches_jax(rng, C, N, ts, CH, ell, cap):
    W, H = 96, 64
    m2, con, col, op, dep, rad, _ = make_2d_scene(rng, C=C, N=N, W=W, H=H,
                                                  CH=CH)
    radii = _elliptical(rng, rad) if ell else rad
    cj, ct = _cfgs(C, N, W, H, ts, CH, cap)
    args = (m2, con, col, op, dep, radii)
    S_j, starts_j, aux = jax.jit(lambda *a: jr._build_sorted(cj, *a))(
        *map(jnp.asarray, args))
    S_t, starts_t, n_isects = tr._build_sorted(
        ct, *map(torch.as_tensor, args))[:3]
    total = int(np.asarray(aux["cum_i32"])[-1])
    assert int(n_isects[0]) == int(aux["n_isects"]) == min(total, cap)
    if cap == 4096:
        assert total > cap  # the truncated tail is dropped identically
    assert_same_sorted(S_t, starts_t, S_j, starts_j, ct)


def _forward_both(m2, con, col, op, dep, radii, W, H, **kw):
    ref = jax.jit(lambda *a: jr.rasterize_to_pixels_v2(*a, W, H, **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()}))(*map(jnp.asarray,
                                       (m2, con, col, op, dep, radii)))
    port = tr.rasterize_to_pixels_v2(m2, con, col, op, dep, radii, W, H,
                                     device="cpu", **kw)
    return port, ref


@pytest.mark.parametrize(
    "ts,cutoff,CH,C,use_bg,use_masks",
    [(16, "exact", 3, 2, True, False), (16, "soft", 3, 2, True, False),
     (32, "exact", 1, 1, False, False), (32, "soft", 4, 1, True, True),
     (16, "exact", 4, 2, False, True)],
)
def test_forward_matches_jax(rng, ts, cutoff, CH, C, use_bg, use_masks):
    W, H = 96, 64
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=C, N=700, W=W,
                                                   H=H, CH=CH)
    radii = _elliptical(rng, rad)
    kw = dict(tile_size=ts, isect_capacity=8192, cutoff_mode=cutoff)
    if use_bg:
        kw["backgrounds"] = bg
    if use_masks:
        kw["masks"] = rng.random((C, -(-H // ts), -(-W // ts))) > 0.3
    (img, alp, meta), (img_j, alp_j, meta_j) = _forward_both(
        m2, con, col, op, dep, radii, W, H, **kw)
    assert int(meta["n_isects"][0]) == int(meta_j["n_isects"]) > 0
    assert_images_close(img, img_j)
    assert_images_close(alp, alp_j)
    assert float(alp.max()) > 0.5


def test_forward_empty_scene_matches_jax(rng):
    W, H = 64, 48
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=1, N=50, W=W, H=H)
    (img, alp, meta), (img_j, alp_j, _) = _forward_both(
        m2, con, col, op, dep, np.zeros_like(rad), W, H, tile_size=16,
        isect_capacity=4096, backgrounds=bg)
    assert int(meta["n_isects"][0]) == 0
    assert not alp.any()
    np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    np.testing.assert_allclose(img.numpy(), np.broadcast_to(
        bg[:, None, None, :], img.shape))


@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_cutoff_rules_match_jax(cutoff):
    """One 16x16 tile, 200 flat Gaussians in depth order. Chunk 0 (list rows
    0-127, red, opacity 0.995) drives T below 1e-4 at its second pair;
    chunk 1 (rows 128-199, blue, opacity 0.3) follows. "exact" drops the
    rest of chunk 0 but starts chunk 1 again from T = 0.005, so blue shows
    (gsplat's per-pixel `done` rule would leave it black); "soft" keeps
    every pair of chunk 0, T ends ~0 and the tile stops before chunk 1."""
    N, W = 200, 16
    m2 = np.full((1, N, 2), 8.0, np.float32)
    con = np.tile(np.array([1e-6, 0.0, 1e-6], np.float32), (1, N, 1))
    col = np.zeros((1, N, 3), np.float32)
    col[0, :128, 0] = 1.0
    col[0, 128:, 2] = 1.0
    op = np.where(np.arange(N) < 128, 0.995, 0.3).astype(np.float32)[None]
    dep = np.linspace(1.0, 2.0, N, dtype=np.float32)[None]
    radii = np.full((1, N, 2), 8, np.int32)
    (img, alp, _), (img_j, alp_j, _) = _forward_both(
        m2, con, col, op, dep, radii, W, W, tile_size=16,
        isect_capacity=4096, cutoff_mode=cutoff)
    assert_images_close(img, img_j)
    assert_images_close(alp, alp_j)
    blue = img[..., 2]
    if cutoff == "exact":
        assert float(blue.min()) > 4e-3
    else:
        assert not blue.any()


@pytest.mark.parametrize("cutoff", ["exact", "soft"])
def test_fwd_pair_counts_follow_the_kernel_loop(rng, cutoff):
    """The plain forward's pair counts, from which the tile-forward
    kernel's operation bound is computed, equal a pair-by-pair walk of the
    kernel's loop (vectorised over a tile's pixels). Four 16x16 tiles hold
    runs longer than one 128-row chunk, so the exact cutoff ends pixels
    inside a chunk and starts them again in the next."""
    W = ts = 16
    N = 700
    m2, con, col, op, dep, rad, _ = make_2d_scene(rng, C=1, N=N, W=2 * W,
                                                  H=2 * W)
    cfg = tr.V2Cfg(C=1, tile_width=2, tile_height=2, tile_size=ts,
                   channels=3, cap=4096, n=N, cutoff=cutoff)
    b = tr._build_sorted(cfg, *map(torch.as_tensor, (
        m2, con, col, op, dep, _elliptical(rng, rad))))
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    _, counts = tr._fwd_plain(b.S, b.starts, masks, cfg, with_counts=True)

    S, starts = b.S.numpy(), b.starts.numpy().astype(np.int64)
    K, eps, f32 = tr.K, tr.TRANSMITTANCE_EPS, np.float32
    want = dict(evaluated=0, tested=0, composited=0)
    p = np.arange(ts * ts)
    for t in range(cfg.n_tiles):
        off, end = starts[t], starts[t + 1]
        assert end - off > K
        px = ((t % 2) * ts + p % ts + 0.5).astype(f32)
        py = ((t // 2) * ts + p // ts + 0.5).astype(f32)
        T = np.ones(p.size, f32)
        for c in range(off // K, -(-end // K)):
            if cutoff == "soft" and not (T > eps).any():
                break
            live = np.ones(p.size, bool)
            for k in range(max(off, c * K), min(end, (c + 1) * K)):
                x, y, ca, cb, cc, o = S[:6, k]
                dx, dy = x - px, y - py
                sigma = ((f32(0.5) * ca) * (dx * dx)
                         + (f32(0.5) * cc) * (dy * dy) + cb * (dx * dy))
                alpha = np.minimum(f32(tr.MAX_ALPHA), o * np.exp(-sigma))
                valid = live & (sigma >= 0) & (alpha >= f32(1 / 255))
                want["evaluated"] += int(live.sum())
                want["tested"] += int(valid.sum())
                t_new = T * (f32(1) - alpha)
                if cutoff == "exact":
                    stop = valid & ~(t_new > eps)
                    live &= ~stop
                    valid &= ~stop
                want["composited"] += int(valid.sum())
                T = np.where(valid, t_new, T)
    assert counts == want
    assert 0 < want["composited"] <= want["tested"] < want["evaluated"]
    # exact: some pixels end inside a chunk; soft composites every pair
    # that passes the alpha test
    assert (want["composited"] < want["tested"]) == (cutoff == "exact")
