"""The 2DGS fused rasterizer's absgrad rows (``absgrad_probe``) against the
JAX package on the CPU, on tests/test_torch_2dgs.py's surfel scene: the
probe's gradient against jax.grad of JAX's fused path (its Pallas kernels
in interpret mode, once per case through a module fixture), with the
exact cutoff and the log scan through the public
rasterize_to_pixels_2dgs_v2, and with the soft cutoff, which neither
public path takes, through both custom-VJP cores. Each gradient within
5e-3 of the reference's largest |value|, test_torch_2dgs.py's bound. The
probe leaves the other gradients as they were, bit for bit; and the plain
tile backward's two rows equal a hand sum over the pixels, in float64, on
surfels that take both branches of sigma = 0.5 min(gw3d, gw2d), within
1e-5 of the row's largest |value| (float32 sums against float64 ones).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops.raster_v2_2dgs import (
    _cfg_2dgs as jcfg_2dgs, _raster_core_2dgs as jcore_2dgs,
    rasterize_to_pixels_2dgs_v2 as jrasterize_2dgs)
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as t2

from tests.test_torch_2dgs import NAMES, N, W, H, _loss, surfels  # noqa: F401

CAP = 8192
TS = 16
TW, TH = -(-W // TS), -(-H // TS)
GRADS = NAMES + ("absgrad_probe",)


def _tile_weights(CB):
    """A seeded cotangent of the core's tile outputs (the median's 0)."""
    w = np.random.default_rng(9).standard_normal(
        (TW * TH, TS * TS, CB + 3)).astype(np.float32)
    w[..., -1] = 0.0
    return w


@pytest.fixture(scope="module")
def jax_probe(surfels):  # noqa: F811
    """jax.grad of JAX's fused path with a zero probe: "exact" and "log"
    through the public function and the loss of test_torch_2dgs.py,
    "soft" through the custom-VJP core and a weighted sum of its tiles."""
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    bg, tgt = jnp.asarray(surfels["bg"]), jnp.asarray(surfels["tgt"])
    probe = jnp.zeros((1, N, 2), jnp.float32)
    out = {}
    for case, log in (("exact", False), ("log", True)):
        def loss(m2, M, col, op, nrm, probe, log=log):
            o = jrasterize_2dgs(m2, M, col, op, nrm, jnp.asarray(dep),
                                jnp.asarray(radii), W, H, tile_size=TS,
                                isect_capacity=CAP, backgrounds=bg,
                                tiles_per_step=1, absgrad_probe=probe,
                                log_composite=log)
            return _loss(*o[:4], tgt, jnp)
        grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
            *map(jnp.asarray, (m2, M, col, op, nrm)), probe)
        out[case] = [np.asarray(g) for g in grads]
    colors_full = np.concatenate([col, nrm], -1)
    CB = colors_full.shape[-1]
    cfg = jcfg_2dgs(1, TW, TH, TS, CB, CAP, N, 1, True, True)._replace(
        cutoff="soft")
    wt = jnp.asarray(_tile_weights(CB))

    def core_loss(m2, M, cf, op, probe):
        tiles, _ = jcore_2dgs(cfg, CB - 4, m2, M, cf, op, jnp.asarray(dep),
                              jnp.asarray(radii), jnp.zeros((0,), jnp.int32),
                              probe)
        return jnp.sum(tiles * wt)

    grads = jax.jit(jax.grad(core_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, (m2, M, colors_full, op)), probe)
    out["soft"] = [np.asarray(g) for g in grads]
    return out


def _port_public(surfels, log, probe):  # noqa: F811
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, M, col, op, nrm)]
    out = t2.rasterize_to_pixels_2dgs_v2(
        *leaves, torch.as_tensor(dep), torch.as_tensor(radii), W, H,
        tile_size=TS, isect_capacity=CAP,
        backgrounds=torch.as_tensor(surfels["bg"]), log_composite=log,
        absgrad_probe=probe, device="cpu")
    _loss(*out[:4], torch.as_tensor(surfels["tgt"]), torch).backward()
    return [t.grad for t in leaves]


def _close(name, got, ref):
    a = got.detach().numpy()
    scale = np.abs(ref).max()
    assert np.isfinite(a).all() and scale > 0, name
    assert np.abs(a - ref).max() <= 5e-3 * scale, name


@pytest.mark.parametrize("case", ["exact", "log"])
def test_probe_gradient_matches_jax(surfels, jax_probe, case):  # noqa: F811
    probe = torch.zeros((1, N, 2), requires_grad=True)
    before = dict(tr.LAUNCHES)
    grads = _port_public(surfels, case == "log", probe)
    assert tr.LAUNCHES == before  # the CPU runs the plain versions
    ref = jax_probe[case]
    for name, g, r in zip(GRADS, grads + [probe.grad], ref):
        _close((case, name), g, r)
    # the filter branch reaches most surfels; the sums are non-negative
    ag = probe.grad
    assert bool((ag >= 0).all()) and int((ag.sum(-1) > 0).sum()) > N // 4
    # the probe changes no other gradient
    for name, g, g0 in zip(NAMES, grads, _port_public(surfels,
                                                      case == "log", None)):
        assert torch.equal(g, g0), (case, name)


def test_probe_gradient_soft_matches_jax(surfels, jax_probe):  # noqa: F811
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    colors_full = np.concatenate([col, nrm], -1)
    CB = colors_full.shape[-1]
    cfg = t2.cfg_2dgs(1, TW, TH, TS, CB, CAP, N, cutoff="soft", absgrad=True)
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, M, colors_full, op)]
    probe = torch.zeros((1, N, 2), requires_grad=True)
    tiles, _ = t2._RasterCore2DGS.apply(
        cfg, CB - 4, *leaves, torch.as_tensor(dep), torch.as_tensor(radii),
        torch.ones(cfg.n_tiles, dtype=torch.int32), probe)
    (tiles * torch.as_tensor(_tile_weights(CB))).sum().backward()
    names = ("means2d", "ray_transforms", "colors", "opacities",
             "absgrad_probe")
    for name, g, r in zip(names, [t.grad for t in leaves] + [probe.grad],
                          jax_probe["soft"]):
        _close(("soft", name), g, r)


def test_plain_rows_match_hand_sum():
    """Two surfels, one a tile, with M = [[su, 0, u0], [0, sv, v0],
    [0, 0, 1]], so at a pixel (dx, dy) away gw3d = (dx/su)^2 + (dy/sv)^2
    and gw2d = 2 (dx^2 + dy^2): surfel A (su 0.5, sv 1) takes the screen
    filter's branch along x and the UV branch along y, surfel B (0.1) the
    filter's. Alone in its tile each composites with T_prev = 1, where the
    backward's v_sig = -alpha (G + v_a), G = sum_c col_c v_c; the rows sum
    |2 dx v_sig| and |2 dy v_sig| over the filter branch's pixels."""
    surf = [(8.5, 7.5, 0.5, 1.0, 0.9), (24.5, 8.5, 0.1, 0.1, 0.8)]
    n = len(surf)
    CB = 7
    means2d = torch.tensor([[[u, v] for u, v, *_ in surf]])
    trans = torch.tensor([[[su, 0.0, u, 0.0, sv, v, 0.0, 0.0, 1.0]
                           for u, v, su, sv, _ in surf]])
    opac = torch.tensor([[o for *_, o in surf]])
    rng = np.random.default_rng(4)
    colors = torch.tensor(rng.random((1, n, CB)), dtype=torch.float32)
    depths = torch.tensor([[1.0, 2.0]])
    radii = torch.full((1, n, 2), 5, dtype=torch.int32)
    for cutoff in ("exact", "soft"):
        cfg = t2.cfg_2dgs(1, 2, 1, TS, CB, tr.CAP_BLOCK, n, cutoff=cutoff,
                          absgrad=True)
        b = t2._build_sorted_2dgs(cfg, means2d, trans, colors, opac, depths,
                                  radii)
        assert int(b.n_isects) == 2
        masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
        tiles = t2.raster_fwd_2dgs(b.S, b.starts, masks, cfg, CB - 4)
        v = torch.tensor(rng.standard_normal(tiles.shape), dtype=torch.float32)
        g = t2._bwd_2dgs_plain(b.S, b.starts, masks, tiles, v, cfg, CB - 4)
        assert g.shape == (12 + CB + 2, cfg.cap)
        # without absgrad, the same rows but the two
        g0 = t2._bwd_2dgs_plain(b.S, b.starts, masks, tiles, v,
                                dataclasses.replace(cfg, absgrad=False),
                                CB - 4)
        assert torch.equal(g[:12 + CB], g0)
        p = np.arange(TS * TS)
        for t, (u, vv, su, sv, op) in enumerate(surf):
            j = int(b.starts[t])  # the tile's one column
            assert int(b.starts[t + 1]) == j + 1
            px = t * TS + p % TS + 0.5
            py = p // TS + 0.5
            dx, dy = u - px, vv - py
            gw3d = (dx / su) ** 2 + (dy / sv) ** 2
            gw2d = 2.0 * (dx * dx + dy * dy)
            alpha = np.minimum(0.999, op * np.exp(-0.5 * np.minimum(gw3d,
                                                                    gw2d)))
            hit = alpha >= 1.0 / 255.0
            vt = v[t].double().numpy()
            G = (vt[:, :CB] * colors[0, t].double().numpy()).sum(-1)
            v_sig = -alpha * (G + vt[:, CB]) * hit
            filt = gw3d > gw2d
            want = [np.abs(2.0 * dx * v_sig)[filt].sum(),
                    np.abs(2.0 * dy * v_sig)[filt].sum()]
            if t == 0:  # both branches among the passing pixels
                assert (hit & filt).sum() > 4 and (hit & ~filt).sum() > 4
            got = g[12 + CB:, j].double().numpy()
            scale = g[12 + CB:].abs().max()
            assert np.abs(got - want).max() <= 1e-5 * float(scale), (cutoff, t)
            # the signed filter rows sum the same terms
            assert abs(float(g[0, j]) - (2.0 * dx * v_sig)[filt].sum()) \
                <= 1e-5 * float(g[0].abs().max())
