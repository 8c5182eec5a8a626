"""gscodec_studio_tpu_torch's 2DGS path against the JAX package on the CPU:
the surfel projection, the skeleton's no-cull expansion, the fused 2DGS
rasterizer forward and backward (the plain versions of the 2DGS tile
kernels, with the reused unpack and segment-sum plain versions) and
rendering.rasterization_2dgs with depth_to_normal. The JAX fused path runs
its Pallas kernels in interpret mode, once per file (module fixtures).

Tolerances:
  * projection: radii equal; floats within 1e-5 of each output's largest
    |value| (einsum order);
  * the no-cull build: the sorted table and tile starts equal, bit for bit;
  * rasterize_to_pixels_2dgs_v2 forward against JAX's: the JAX test's own
    tolerances (rtol 1e-3, atol 1e-4; distortion atol 2e-4; median rtol
    1e-4, atol 1e-4): T and the lane prefix sums round differently;
  * its gradients against jax.grad of JAX's fused path: each within 5e-3
    of the reference's largest |value|, the JAX test's own bound;
  * rasterization_2dgs, each backend against JAX's same backend: 1e-4
    absolute on the renders, 1e-3 on the depth normals (finite
    differences of the depth, normalised by small cross products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops.projection_2dgs import (
    fully_fused_projection_2dgs as jprojection)
from gscodec_studio_tpu.ops.raster_v2_2dgs import (
    _build_sorted_2dgs as jbuild_2dgs, _cfg_2dgs as jcfg_2dgs,
    rasterize_to_pixels_2dgs_v2 as jrasterize_2dgs)
from gscodec_studio_tpu.rendering import (
    depth_to_normal as jdepth_to_normal,
    rasterization_2dgs as jrasterization_2dgs)
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as t2
from gscodec_studio_tpu_torch.ops.projection_2dgs import (
    fully_fused_projection_2dgs)
from gscodec_studio_tpu_torch.ops.rasterize_ref_2dgs import (
    rasterize_to_pixels_2dgs_ref)
from gscodec_studio_tpu_torch.rendering import (depth_to_normal,
                                                rasterization_2dgs)

from tests.conftest import make_test_scene

W, H, N = 48, 32, 160
NAMES = ("means2d", "ray_transforms", "colors", "opacities", "normals")


def _scene_args(scene, n=N, scale=0.5):
    return [scene["means"][:n], scene["quats"][:n], scene["scales"][:n]
            * scale, scene["viewmats"][:1], scene["Ks"][:1]]


@pytest.fixture(scope="module")
def surfels():
    """tests/test_raster_v2_2dgs.py's scene: N projected surfels (elliptical
    radii, the fused path's), opacities, RGB + depth colours, a background
    and a seeded target of the loss of that file."""
    rng = np.random.default_rng(42)
    scene = make_test_scene(rng)
    radii, m2, dep, M, nrm = jprojection(
        *map(jnp.asarray, _scene_args(scene)), W, H, elliptical=True)
    opac = (0.3 + 0.65 * rng.random((1, N))).astype(np.float32)
    rgb = rng.random((1, N, 3)).astype(np.float32)
    colors = np.concatenate([rgb, np.asarray(dep)[..., None]], -1)
    bg = rng.random((1, 4)).astype(np.float32)
    tgt = np.random.default_rng(7).random((1, H, W, 4), np.float32)
    arrays = [np.array(x) for x in (m2, M, colors, opac, nrm, dep, radii)]
    return dict(args=arrays, bg=bg, tgt=tgt, scene=scene)


def _loss(img, alp, nrm, dist, tgt, xp):
    return (xp.sum((img - tgt) ** 2) + 0.3 * xp.sum(alp ** 2)
            + 0.2 * xp.sum(nrm * nrm) + 0.5 * xp.sum(dist))


@pytest.fixture(scope="module")
def jax_fused(surfels):
    """JAX's fused forward and its gradients, in interpret mode: one
    compile of value_and_grad with the forward's outputs as aux."""
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    bg, tgt = jnp.asarray(surfels["bg"]), jnp.asarray(surfels["tgt"])

    def loss(m2, M, col, op, nrm):
        out = jrasterize_2dgs(m2, M, col, op, nrm, jnp.asarray(dep),
                              jnp.asarray(radii), W, H, tile_size=16,
                              isect_capacity=8192, backgrounds=bg,
                              tiles_per_step=1)
        return _loss(*out[:4], tgt, jnp), out[:5]

    (value, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, (m2, M, col, op, nrm)))
    return (float(value), [np.asarray(o) for o in outs],
            [np.asarray(g) for g in grads])


def test_projection_2dgs_matches_jax(surfels):
    rng = np.random.default_rng(3)
    args = _scene_args(surfels["scene"], n=300, scale=1.0)
    opac = rng.random(300).astype(np.float32)
    for elliptical in (False, True):
        for op in (None, opac):
            ref = jprojection(*map(jnp.asarray, args), W, H,
                              opacities=None if op is None
                              else jnp.asarray(op), elliptical=elliptical)
            got = fully_fused_projection_2dgs(
                *map(torch.as_tensor, args), W, H,
                opacities=None if op is None else torch.as_tensor(op),
                elliptical=elliptical)
            assert got[0].dtype == torch.int32
            assert got[0].shape == ref[0].shape
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            assert int((got[0] > 0).sum()) > 50
            for a, b in zip(got[1:], ref[1:]):
                b = np.asarray(b)
                scale = np.abs(b).max()
                assert np.abs(a.numpy() - b).max() <= 1e-5 * scale


def test_no_cull_build_matches_jax(surfels):
    """The skeleton with cull=False (every in-range pair keeps its tile)
    against the JAX package's _build_sorted_generic with cull=False."""
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    C = 1
    TW, TH = -(-W // 16), -(-H // 16)
    colors_full = np.concatenate([col, nrm], -1)
    CB = colors_full.shape[-1]
    jcfg = jcfg_2dgs(C, TW, TH, 16, CB, 8192, N, 1, True, False)
    S_j, starts_j, aux = jbuild_2dgs(
        jcfg, CB - 4, *map(jnp.asarray, (m2, M, colors_full, op, dep,
                                         radii)))
    cfg = t2.cfg_2dgs(C, TW, TH, 16, CB, 8192, N)
    b = t2._build_sorted_2dgs(cfg, *map(torch.as_tensor, (
        m2, M, colors_full, op, dep, radii)))
    n = int(b.n_isects[0])
    assert n == int(aux["n_isects"]) > 100
    # no pair goes to the cull's overflow tile
    assert int((b.tile[:n] == cfg.n_tiles).sum()) == 0
    S_j = np.asarray(S_j)
    assert not S_j[cfg.d_s:].any()  # the JAX layout's zero padding rows
    np.testing.assert_array_equal(b.S.numpy(), S_j[:cfg.d_s])
    np.testing.assert_array_equal(b.starts.numpy(), np.asarray(starts_j))
    # and the expansion itself against a dense count of each AABB's tiles
    _, _, _, counts = tr.tile_counts(torch.as_tensor(m2),
                                     torch.as_tensor(radii), 16, TW, TH)
    assert int(counts.sum()) == n


def test_fused_forward_matches_jax(surfels, jax_fused):
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    _, ref, _ = jax_fused
    img, alp, n_img, dist, med, meta = t2.rasterize_to_pixels_2dgs_v2(
        *map(torch.as_tensor, (m2, M, col, op, nrm, dep, radii)), W, H,
        tile_size=16, isect_capacity=8192,
        backgrounds=torch.as_tensor(surfels["bg"]), device="cpu")
    assert int(meta["n_isects"][0]) > 100
    assert int((alp > 0.05).sum()) > 50
    got = [img, alp, n_img, dist, med]
    tols = [(1e-3, 1e-4)] * 3 + [(1e-3, 2e-4), (1e-4, 1e-4)]
    for a, b, (rtol, atol) in zip(got, ref, tols):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)
    assert not med.requires_grad


def test_fused_gradients_match_jax(surfels, jax_fused):
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    value, _, ref = jax_fused
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, M, col, op, nrm)]
    before = dict(tr.LAUNCHES)
    out = t2.rasterize_to_pixels_2dgs_v2(
        *leaves, torch.as_tensor(dep), torch.as_tensor(radii), W, H,
        tile_size=16, isect_capacity=8192,
        backgrounds=torch.as_tensor(surfels["bg"]), device="cpu")
    loss = _loss(*out[:4], torch.as_tensor(surfels["tgt"]), torch)
    loss.backward()
    assert tr.LAUNCHES == before  # the CPU runs the plain versions
    assert float(loss.detach()) == pytest.approx(value, rel=2e-4)
    for name, t, b in zip(NAMES, leaves, ref):
        a = t.grad.numpy()
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= 5e-3 * scale, name


def test_fused_plain_matches_oracle_soft_and_masked(surfels):
    """The soft cutoff and tile masks, which JAX's public 2DGS path does
    not take: the plain tile forward against the port's own oracle where
    nothing is masked, and zero output on masked tiles."""
    m2, M, col, op, nrm, dep, radii = map(torch.as_tensor, surfels["args"])
    radii = radii.amax(-1)  # the oracle's square rule, for both
    colors_full = torch.cat([col, nrm], -1)
    CB = colors_full.shape[-1]
    cfg = t2.cfg_2dgs(1, 3, 2, 16, CB, 8192, N, cutoff="soft")
    b = t2._build_sorted_2dgs(cfg, m2, M, colors_full, op, dep, radii)
    masks = torch.tensor([1, 0, 1, 1, 1, 0], dtype=torch.int32)
    tiles = t2.raster_fwd_2dgs(b.S, b.starts, masks, cfg, CB - 4)
    assert not tiles.reshape(6, -1)[masks == 0].any()
    ref = rasterize_to_pixels_2dgs_ref(m2, M, col, op, nrm, dep, radii, W,
                                       H, 16)
    img = tiles.reshape(1, 2, 3, 16, 16, CB + 3).permute(
        0, 1, 3, 2, 4, 5).reshape(1, 32, 48, CB + 3)
    keep = masks.reshape(2, 3).repeat_interleave(16, 0).repeat_interleave(
        16, 1).bool()[None]
    for got, want in ((img[..., :CB - 3], ref[0]), (img[..., CB:CB + 1],
                                                    ref[1])):
        d = (got - want).abs()[keep]
        # the soft cutoff composites the tail below T = 1e-4 the oracle drops
        assert float(d.max()) <= 2e-3


def test_rasterization_2dgs_matches_jax(surfels):
    """Each backend against the JAX package's same backend. The two bin
    differently by design: "fused" by the opacity-aware per-axis AABB,
    "reference" by the square of the larger radius. The screen-space
    filter (sigma <= |mean - pixel|^2) lets a pair pass 1/255 up to ~2.3 px
    from its mean, outside the AABB of a surfel seen edge on, so the two
    backends differ on such pixels in both packages."""
    rng = np.random.default_rng(5)
    scene = surfels["scene"]
    n = 200
    args = [scene["means"][:n], scene["quats"][:n], scene["scales"][:n],
            (0.3 + 0.5 * rng.random(n)).astype(np.float32),
            (rng.standard_normal((n, 4, 3)) * 0.3).astype(np.float32),
            scene["viewmats"][:1], scene["Ks"][:1]]
    names = ("colors", "alphas", "normals", "surf_normals", "distort",
             "median")
    for backend, depth_mode in (("reference", "median"),
                                ("fused", "expected")):
        kw = dict(sh_degree=1, render_mode="RGB+ED", isect_capacity=8192,
                  depth_mode=depth_mode)

        def render(*a):
            out = jrasterization_2dgs(*a, W, H, rasterizer=backend, **kw)
            return out[:6], out[6]["radii"]

        ref, ref_radii = jax.jit(render)(*map(jnp.asarray, args))
        got = rasterization_2dgs(*args, W, H, rasterizer=backend,
                                 device="cpu", **kw)
        for name, a, b in zip(names, got[:6], ref):
            b = np.asarray(b)
            assert a.shape == b.shape, name
            tol = 1e-3 if name == "surf_normals" else 1e-4
            assert np.abs(a.numpy() - b).max() <= tol, (backend, name)
        assert float(got[1].mean()) > 0.05
        np.testing.assert_array_equal(got[6]["radii"].numpy(),
                                      np.asarray(ref_radii))


def test_depth_to_normal_matches_jax():
    rng = np.random.default_rng(11)
    depth = (2.0 + rng.random((2, 20, 24, 1))).astype(np.float32)
    depth[0, 5:9, 6:10] = 2.5  # a flat patch: n = 0 inside
    vm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K = np.array([[[30, 0, 12], [0, 30, 10], [0, 0, 1]]] * 2, np.float32)
    ref = jdepth_to_normal(jnp.asarray(depth), jnp.asarray(vm),
                           jnp.asarray(K))
    d = torch.tensor(depth, requires_grad=True)
    got = depth_to_normal(d, torch.as_tensor(vm), torch.as_tensor(K))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(d.grad).all()


def test_fused_path_raises_for_unported_options(surfels):
    cfg = t2.cfg_2dgs(1, 3, 2, 16, 7, 4096, N)
    with pytest.raises(ValueError, match="depth channel"):
        t2.raster_fwd_2dgs(torch.zeros(cfg.d_s, cfg.cap),
                           torch.zeros(cfg.n_tiles_v + 1, dtype=torch.int32),
                           torch.ones(cfg.n_tiles, dtype=torch.int32), cfg, 4)
