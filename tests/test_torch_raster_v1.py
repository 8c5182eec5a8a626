"""gscodec_studio_tpu_torch's legacy v1 rasterizer (ops/isect.py and the
plain versions of B7 and B8 in ops/rasterize_pallas.py) and
``rasterization(rasterizer="pallas"/"reference")`` against the JAX
package on the CPU; the JAX side runs its Pallas kernels in interpret
mode. Inputs are made from seeds with numpy and fed to both packages.

Tolerances:
  * isect_tiles, align_isects, isect_offset_encode and the chunk map: bit
    for bit (the depths compared as their bits). jax.lax.sort is not
    stable, so the scenes have distinct depths;
  * rasterize_to_pixels forward: max abs 1e-5 on colours and alphas (the
    transmittance products and colour sums are taken in another order);
  * gradients to means2d, conics, colors and opacities: max abs 1e-4 of
    each gradient's largest |value| in every SEGRED_MODE and cutoff (the
    backward's sums over pixels and its f32 cumulative sums are taken in
    another order);
  * rasterization and render_splats through the whole pipeline: as
    test_torch_rendering (max abs 5e-3 with >= 99.9% of values within
    1e-4: the projection and SH are computed in another order), with the
    binning's meta keys equal.

tests/conftest.py sets the JAX module's CUTOFF_MODE to "exact" in every
test process; each test here sets both packages' switches itself.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import isect as jisect
from gscodec_studio_tpu.ops import rasterize_pallas as jrp
from gscodec_studio_tpu.rendering import rasterization as jrasterization
from gscodec_studio_tpu.utils import ply_render as jply
from gscodec_studio_tpu_torch.models.splats import from_jax_splats
from gscodec_studio_tpu_torch.ops import isect as tisect
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops import rasterize_pallas as trp
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.utils import ply_render as tply

from tests.conftest import make_test_scene
from tests.test_rasterize_pallas import make_2d_scene
from tests.test_torch_raster_v2 import assert_images_close

CHECKPOINT = (Path(__file__).resolve().parents[1] / "results"
              / "garden_ab_f32" / "splats_final.npz")
W, H, TS = 48, 32, 16


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_math():
    """The CPU build of torch these tests run on (2.13.0+cpu, 8 threads)
    can return a torch.exp off by ~1e-4 on the first large call in a
    process. torch alone shows it, with no code of either package loaded:

        g = torch.Generator().manual_seed(s)
        x = -torch.rand(1 << 20, generator=g) * 5
        (torch.exp(x).double() - torch.exp(x.double())).abs().max()

    run once in each of 30 fresh processes (s = 1..30) gave 1.06e-4 in 6
    of them and ~3e-8 in the rest; a second torch.exp(x) in the same
    process gave ~3e-8 in all 30. One throwaway call before the 1e-5
    comparisons."""
    torch.exp(-torch.rand(1 << 20) * 5)


@pytest.fixture
def modes(monkeypatch):
    """set(cutoff, segred) sets both packages' module switches."""

    def set_(cutoff="exact", segred="sort"):
        for mod in (jrp, trp):
            monkeypatch.setattr(mod, "CUTOFF_MODE", cutoff)
            monkeypatch.setattr(mod, "SEGRED_MODE", segred)

    return set_


def _isects(scene, C, cap):
    means2d, _, _, _, depths, radii, _ = scene
    tw, th = -(-W // TS), -(-H // TS)
    ij = jisect.isect_tiles(jnp.asarray(means2d), jnp.asarray(radii),
                            jnp.asarray(depths), TS, tw, th, cap)
    it = tisect.isect_tiles(torch.as_tensor(means2d), torch.as_tensor(radii),
                            torch.as_tensor(depths), TS, tw, th, cap)
    return ij, it


def _eq(t, j, name):
    t = t.numpy()
    j = np.asarray(j)
    if t.dtype == np.float32:
        t, j = t.view(np.int32), j.view(np.int32)
    assert t.shape == j.shape, name
    np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("cap", [8192, 256])
@pytest.mark.parametrize("C", [1, 2])
def test_isect_align_and_chunk_map_match_jax(rng, C, cap):
    scene = make_2d_scene(rng, C=C)
    tw, th = -(-W // TS), -(-H // TS)
    ij, it = _isects(scene, C, cap)
    total = int(np.asarray(ij.tiles_per_gauss).sum())
    assert (total > cap) == (cap == 256)  # the small capacity truncates
    for name in ij._fields:
        _eq(getattr(it, name), getattr(ij, name), name)
    _eq(tisect.isect_offset_encode(it.tile_keys, C, tw, th),
        jisect.isect_offset_encode(ij.tile_keys, C, tw, th), "offsets")
    aj = jisect.align_isects(ij, C, tw, th, 128)
    at = tisect.align_isects(it, C, tw, th, 128)
    for name in aj._fields:
        _eq(getattr(at, name), getattr(aj, name), "aligned " + name)
    cfg_j = jrp.RasterCfg(C=C, tile_width=tw, tile_height=th, tile_size=TS,
                          channels=3, cap=cap, cap2=aj.ids.shape[0],
                          interpret=True)
    cfg_t = trp.RasterCfg(C=C, tile_width=tw, tile_height=th, tile_size=TS,
                          channels=3, cap=cap, cap2=at.ids.shape[0])
    _eq(trp._chunk_tile_map(cfg_t, at.starts, at.ends),
        jrp._chunk_tile_map(cfg_j, aj.starts, aj.ends), "chunk map")
    at0 = tisect.align_isects(it, C, tw, th, 128, need_inv_perm=False)
    assert at0.inv_perm.shape == (1,)
    _eq(at0.ids, aj.ids, "ids without inv_perm")


def _raster_inputs(scene):
    means2d, conics, colors, opacities, _, _, bg = scene
    return means2d, conics, colors, opacities, bg


@pytest.mark.parametrize("cutoff", ["exact", "soft"])
@pytest.mark.parametrize("CH", [3, 8])
@pytest.mark.parametrize("C", [1, 2])
def test_forward_matches_jax(rng, modes, C, CH, cutoff):
    modes(cutoff)
    scene = make_2d_scene(rng, C=C, CH=CH)
    ij, it = _isects(scene, C, 2048)
    m2d, con, col, opa, bg = _raster_inputs(scene)
    img_j, alp_j = jrp.rasterize_to_pixels(
        *map(jnp.asarray, (m2d, con, col, opa)), ij, None, W, H, TS,
        backgrounds=jnp.asarray(bg))
    tr.reset_launch_counts()
    img, alp = trp.rasterize_to_pixels(
        *map(torch.as_tensor, (m2d, con, col, opa)), it, None, W, H, TS,
        backgrounds=torch.as_tensor(bg))
    assert tr.LAUNCHES["raster_v1_fwd"] == 0  # the CPU runs the plain one
    assert float(alp.max()) > 0.5
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(alp.numpy(), np.asarray(alp_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("cutoff", ["exact", "soft"])
@pytest.mark.parametrize("segred", ["sort", "scatter", "cumsum"])
def test_gradients_match_jax(rng, modes, segred, cutoff):
    modes(cutoff, segred)
    scene = make_2d_scene(rng, C=1, N=150)
    ij, it = _isects(scene, 1, 2048)
    m2d, con, col, opa, bg = _raster_inputs(scene)
    tgt = rng.random((1, H, W, 3)).astype(np.float32)

    def jloss(*a):
        img, alp = jrp.rasterize_to_pixels(*a, ij, None, W, H, TS,
                                           backgrounds=jnp.asarray(bg))
        return jnp.sum((img - tgt) ** 2) + 0.3 * jnp.sum(alp ** 2)

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (m2d, con, col, opa)))
    leaves = [torch.tensor(x, requires_grad=True) for x in
              (m2d, con, col, opa)]
    img, alp = trp.rasterize_to_pixels(*leaves, it, None, W, H, TS,
                                       backgrounds=torch.as_tensor(bg))
    loss = ((img - torch.as_tensor(tgt)) ** 2).sum() + 0.3 * (alp ** 2).sum()
    gt = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(("means2d", "conics", "colors", "opacities"), gt,
                          gj):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_empty_scene():
    """No visible Gaussian: the background everywhere, alpha 0, and zero
    gradients."""
    C, N, w, h, CH = 1, 16, 32, 32, 3
    means2d = torch.zeros((C, N, 2), requires_grad=True)
    conics = torch.tensor([0.1, 0.0, 0.1]).repeat(C, N, 1)
    colors = torch.ones((C, N, CH), requires_grad=True)
    opac = torch.ones((C, N))
    radii = torch.zeros((C, N), dtype=torch.int32)
    isect = tisect.isect_tiles(means2d.detach(), radii, torch.ones((C, N)),
                               TS, 2, 2, 1024)
    bg = torch.tensor([[0.25, 0.5, 0.75]])
    img, alp = trp.rasterize_to_pixels(means2d, conics, colors, opac, isect,
                                       None, w, h, TS, backgrounds=bg)
    assert float(alp.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(img.detach().numpy(),
                                  bg[:, None, None, :].expand_as(img).numpy())
    g = torch.autograd.grad(img.sum() + alp.sum(), [means2d, colors])
    assert all(float(x.abs().max()) == 0.0 for x in g)


@pytest.mark.parametrize("backend,mode,D", [
    ("pallas", "RGB", 3), ("pallas", "RGB+ED", 3), ("reference", "RGB", 3),
    ("reference", "RGB+ED", 3), ("pallas", "RGB", 40)])
def test_rasterization_matches_jax(rng, modes, backend, mode, D):
    """rasterization with a non-fused backend, in RGB and RGB+ED, and at
    40 channels (two channel chunks): images, alphas and the binning's
    meta keys."""
    modes("exact")
    Wr, Hr, N = 64, 48, 300
    sc = make_test_scene(rng, C=1, N=N, width=Wr, height=Hr)
    colors = rng.random((N, D)).astype(np.float32)
    bg = rng.random((1, D)).astype(np.float32)
    args = [sc[k] for k in ("means", "quats", "scales", "opacities")] + [
        colors, sc["viewmats"], sc["Ks"]]
    kw = dict(render_mode=mode, isect_capacity=4096, rasterizer=backend)
    img_j, alp_j, meta_j = jrasterization(*map(jnp.asarray, args), Wr, Hr,
                                          backgrounds=jnp.asarray(bg), **kw)
    img, alp, meta = rasterization(*args, Wr, Hr, backgrounds=bg,
                                   device="cpu", **kw)
    assert int(meta["n_isects"]) == int(meta_j["n_isects"]) > 0
    for key in ("tiles_per_gauss", "tile_keys", "flatten_ids",
                "tile_offsets", "n_isects"):
        _eq(meta[key], meta_j[key], key)
    assert_images_close(img, img_j)
    assert_images_close(alp, alp_j)


def test_absgrad_probe_needs_the_fused_backend(rng):
    sc = make_test_scene(rng, C=1, N=20, width=32, height=32)
    args = [sc[k] for k in ("means", "quats", "scales", "opacities")] + [
        rng.random((20, 3)).astype(np.float32), sc["viewmats"], sc["Ks"]]
    with pytest.raises(ValueError, match="fused"):
        rasterization(*args, 32, 32, rasterizer="pallas",
                      absgrad_probe=torch.zeros((1, 20, 2)), device="cpu")


def test_render_splats_pallas_matches_jax(modes):
    modes("soft")  # the JAX package's default, as a user renders
    with np.load(CHECKPOINT) as z:
        splats = {k: z[k][:2000] for k in z.files}
    cams = jply.orbit_cameras(splats["means"], n_views=2, width=64,
                              height=48)
    ref = jply.render_splats(splats, cams, isect_capacity=1 << 14,
                             rasterizer="pallas")
    out = tply.render_splats(from_jax_splats(splats, device="cpu"), cams,
                             isect_capacity=1 << 14, rasterizer="pallas")
    for (rgb, alpha, meta), r in zip(out, ref):
        assert "tile_offsets" in meta and int(meta["n_isects"]) > 0
        assert float(alpha.mean()) > 0.05
        assert_images_close(rgb, r)
