"""The port's cameras and covariance ops against the JAX package on the
CPU: the quaternion functions (triu both ways), world_to_cam, proj for the
pinhole, ortho and fisheye cameras, fully_fused_projection's general
branch (explicit covariances, or a camera other than pinhole) with its
gradients against jax.grad, rasterization under ortho and fisheye on the
fused and the reference backends, and rasterize_to_indices_in_range.
Inputs are made with numpy from a seed; fisheye data lie off the optical
axis, where sqrt(x^2 + y^2) has an infinite gradient in both packages.

Tolerances:
  * values: 1e-5 relative, atol 1e-6 of the values' scale (two float32
    chains that order or fuse their operations differently); integer
    radii equal;
  * gradients: 2e-4 relative, atol 2e-5 of each gradient's scale (the
    backward multiplies those rounding differences by the Jacobians);
  * rendered images and alphas: tests/test_torch_raster_v2's
    assert_images_close (max abs <= 5e-3, >= 99.9% within 1e-4), equal
    n_isects; their gradients 1e-3 relative of each gradient's scale;
  * rasterize_to_indices_in_range: the index lists and n_valid equal,
    the transmittances within 1e-5.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import indices_range as jidx
from gscodec_studio_tpu.ops import projection as jproj
from gscodec_studio_tpu.ops import quat as jquat
from gscodec_studio_tpu.ops import raster_v2 as jraster
from gscodec_studio_tpu.ops import transforms as jtf
from gscodec_studio_tpu.rendering import rasterization as jrasterization
import gscodec_studio_tpu_torch.ops as tops
from gscodec_studio_tpu_torch.ops import indices_range as tidx
from gscodec_studio_tpu_torch.ops import projection as tproj
from gscodec_studio_tpu_torch.ops import quat as tquat
from gscodec_studio_tpu_torch.rendering import rasterization

from tests.conftest import make_test_scene
from tests.test_torch_raster_v2 import assert_images_close

W, H = 64, 48


def _close(port, ref, rtol=1e-5, atol=1e-6):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol * scale)


def _grad_close(port, ref):
    _close(port, ref, rtol=2e-4, atol=2e-5)


def _scene(rng, model, N=300, C=2):
    """make_test_scene's splats and views; ortho views get fx = fy = the
    width over the scene's extent (pixels per world unit)."""
    sc = make_test_scene(rng, C=C, N=N, width=W, height=H)
    if model == "ortho":
        sc["Ks"] = sc["Ks"].copy()
        sc["Ks"][:, 0, 0] = sc["Ks"][:, 1, 1] = W / 3.0
    sc["opacities"] = (0.02 + 0.98 * rng.random(N)).astype(np.float32)
    return sc


def test_quat_functions_match_jax(rng):
    q = rng.standard_normal((400, 4)).astype(np.float32)
    s = np.exp(rng.normal(-2, 0.5, (400, 3))).astype(np.float32)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s)
    jq, js = jnp.asarray(q), jnp.asarray(s)
    _close(tquat.quat_scale_to_preci(tq, ts),
           jquat.quat_scale_to_preci(jq, js), rtol=1e-4)
    for cov, pre, triu in itertools.product((True, False), (True, False),
                                            (True, False)):
        t = tquat.quat_scale_to_covar_preci(tq, ts, cov, pre, triu)
        j = jquat.quat_scale_to_covar_preci(jq, js, cov, pre, triu)
        for a, b in zip(t, j):
            assert (a is None) == (b is None)
            if a is not None:
                _close(a, b, rtol=1e-4)
    m = np.asarray(jquat.quat_scale_to_covar(jq, js))
    packed = tquat._triu_pack(torch.as_tensor(m))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jquat._triu_pack(m)))
    np.testing.assert_array_equal(tquat.triu_unpack(packed).numpy(),
                                  np.asarray(jquat.triu_unpack(
                                      jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(tquat.triu_unpack(packed).numpy(), m)


def test_world_to_cam_matches_jax(rng):
    sc = make_test_scene(rng, C=3, N=200)
    cov = np.asarray(jquat.quat_scale_to_covar(jnp.asarray(sc["quats"]),
                                               jnp.asarray(sc["scales"])))
    t = tops.world_to_cam(torch.as_tensor(sc["means"]), torch.as_tensor(cov),
                          torch.as_tensor(sc["viewmats"]))
    j = jtf.world_to_cam(jnp.asarray(sc["means"]), jnp.asarray(cov),
                         jnp.asarray(sc["viewmats"]))
    for a, b in zip(t, j):
        _close(a, b)


@pytest.mark.parametrize("model", ["pinhole", "ortho", "fisheye"])
def test_proj_matches_jax_with_gradients(rng, model):
    sc = _scene(rng, model, N=200)
    cov = np.asarray(jquat.quat_scale_to_covar(jnp.asarray(sc["quats"]),
                                               jnp.asarray(sc["scales"])))
    mc, cc = (np.asarray(x) for x in jtf.world_to_cam(
        jnp.asarray(sc["means"]), jnp.asarray(cov),
        jnp.asarray(sc["viewmats"])))
    assert float(np.hypot(mc[..., 0], mc[..., 1]).min()) > 1e-3
    g_m = rng.standard_normal(mc.shape[:2] + (2,)).astype(np.float32)
    g_c = rng.standard_normal(mc.shape[:2] + (2, 2)).astype(np.float32)

    def jloss(m, c):
        m2, c2 = jproj.proj(m, c, jnp.asarray(sc["Ks"]), W, H, model)
        return jnp.sum(m2 * g_m) + jnp.sum(c2 * g_c), (m2, c2)

    (_, (jm2, jc2)), (jgm, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(mc),
                                             jnp.asarray(cc))
    tm = torch.tensor(mc, requires_grad=True)
    tc = torch.tensor(cc, requires_grad=True)
    m2, c2 = tops.proj(tm, tc, torch.as_tensor(sc["Ks"]), W, H, model)
    ((m2 * torch.as_tensor(g_m)).sum()
     + (c2 * torch.as_tensor(g_c)).sum()).backward()
    _close(m2, jm2)
    _close(c2, jc2)
    _grad_close(tm.grad, jgm)
    _grad_close(tc.grad, jgc)
    with pytest.raises(ValueError):
        tops.proj(tm, tc, torch.as_tensor(sc["Ks"]), W, H, "equirect")


CASES = [c for c in itertools.product(
    ("pinhole", "ortho", "fisheye"), (False, True), (False, True),
    (False, True), (False, True)) if c[0] != "pinhole" or c[2]]


@pytest.mark.parametrize("model,comp,covars,elliptical,opac", CASES)
def test_general_branch_matches_jax(rng, model, comp, covars, elliptical,
                                    opac):
    """fully_fused_projection's general branch (every camera model with
    explicit covariances, ortho and fisheye from quats and scales): the
    outputs and the gradients of a seeded weighting of them with respect
    to the means and the quats and scales or the covariances."""
    sc = _scene(rng, model)
    N = sc["means"].shape[0]
    cov = np.asarray(jquat.quat_scale_to_covar(jnp.asarray(sc["quats"]),
                                               jnp.asarray(sc["scales"])))
    w = [rng.standard_normal((2, N) + s).astype(np.float32)
         for s in ((2,), (), (3,), ())]
    kw = dict(calc_compensations=comp, camera_model=model,
              elliptical=elliptical, near_plane=0.5, far_plane=8.0)

    def weigh(out, asarray):
        s = sum((o * asarray(g)).sum() for o, g in zip(out[1:4], w[:3]))
        return s + (out[4] * asarray(w[3])).sum() if comp else s

    op = sc["opacities"] if opac else None
    vm, Ks = sc["viewmats"], sc["Ks"]

    def jfun(means, a, b):
        out = jproj.fully_fused_projection(
            means, a if covars else None, None if covars else a,
            None if covars else b, jnp.asarray(vm), jnp.asarray(Ks), W, H,
            opacities=None if op is None else jnp.asarray(op), **kw)
        return weigh(out, jnp.asarray), out

    jargs = [jnp.asarray(sc["means"])] + (
        [jnp.asarray(cov), None] if covars else
        [jnp.asarray(sc["quats"]), jnp.asarray(sc["scales"])])
    argnums = (0, 1) if covars else (0, 1, 2)
    (_, jout), jgrads = jax.value_and_grad(jfun, argnums=argnums,
                                           has_aux=True)(*jargs)
    targs = [torch.tensor(np.asarray(a), requires_grad=True)
             for a in jargs if a is not None]
    tout = tproj.fully_fused_projection(
        targs[0], targs[1] if covars else None,
        None if covars else targs[1], None if covars else targs[2],
        torch.as_tensor(vm), torch.as_tensor(Ks), W, H,
        opacities=None if op is None else torch.as_tensor(op), **kw)
    weigh(tout, torch.as_tensor).backward()
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert int((tout[0] > 0).sum()) > N // 4
    for a, b in zip(tout[1:4], jout[1:4]):
        _close(a, b)
    assert (tout[4] is None) == (not comp)
    if comp:
        _close(tout[4], jout[4])
    for t, j in zip(targs, jgrads):
        _grad_close(t.grad, j)


def test_pinhole_covars_take_the_general_branch(rng, monkeypatch):
    """Pinhole with explicit covariances goes through persp_proj, as in
    the JAX package, and agrees with the fast path from quats and scales
    to float32 rounding."""
    sc = _scene(rng, "pinhole")
    cov = tquat.quat_scale_to_covar(torch.as_tensor(sc["quats"]),
                                    torch.as_tensor(sc["scales"]))
    args = [torch.as_tensor(sc[k]) for k in ("viewmats", "Ks")]
    calls = []
    persp = tproj.persp_proj
    monkeypatch.setitem(tproj._PROJ_FNS, "pinhole",
                        lambda *a: calls.append(1) or persp(*a))
    general = tproj.fully_fused_projection(
        torch.as_tensor(sc["means"]), cov, None, None, *args, W, H)
    assert calls == [1]
    fast = tproj.fully_fused_projection(
        torch.as_tensor(sc["means"]), None, torch.as_tensor(sc["quats"]),
        torch.as_tensor(sc["scales"]), *args, W, H)
    assert calls == [1]
    np.testing.assert_array_equal(general[0].numpy(), fast[0].numpy())
    for a, b in zip(general[1:4], fast[1:4]):
        _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("model,backend", [
    ("ortho", "fused"), ("fisheye", "fused"), ("ortho", "reference"),
    ("fisheye", "reference")])
def test_rasterization_cameras_match_jax(rng, model, backend, monkeypatch):
    """rasterization(camera_model=...) forward and backward against the
    JAX package's same backend (the fused one in interpret mode, a tile a
    grid step, which compiles faster), RGB from SH degree 1 on two
    views."""
    monkeypatch.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
        jraster.rasterize_to_pixels_v2, tiles_per_step=1))
    sc = _scene(rng, model, N=250)
    N = sc["means"].shape[0]
    colors = (rng.standard_normal((N, 4, 3)) * 0.3).astype(np.float32)
    names = ("means", "quats", "scales", "opacities")
    arrays = [sc[k] for k in names] + [colors]
    cot = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    kw = dict(sh_degree=1, camera_model=model, rasterizer=backend,
              isect_capacity=8192)

    def jfun(*a):
        img, alp, meta = jrasterization(*a, jnp.asarray(sc["viewmats"]),
                                        jnp.asarray(sc["Ks"]), W, H, **kw)
        return jnp.sum(img * cot), (img, alp, meta["n_isects"])

    (_, (jimg, jalp, jn)), jgrads = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, arrays))
    targs = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    img, alp, meta = rasterization(*targs, sc["viewmats"], sc["Ks"], W, H,
                                   device="cpu", **kw)
    (img * torch.as_tensor(cot)).sum().backward()
    img, alp = img.detach(), alp.detach()
    assert float(alp.mean()) > 0.05
    assert int(torch.as_tensor(meta["n_isects"]).sum()) == int(
        np.asarray(jn).sum()) > 0
    assert_images_close(img, jimg)
    assert_images_close(alp, jalp)
    for t, j in zip(targs, jgrads):
        _close(t.grad, j, rtol=1e-3, atol=1e-3)


def test_indices_in_range_match_jax(rng):
    w, h = 24, 16
    sc = make_test_scene(rng, C=2, N=80, width=w, height=h)
    args = [torch.as_tensor(sc[k]) for k in
            ("means", "quats", "scales", "viewmats", "Ks")]
    radii, means2d, depths, conics, _ = tproj.fully_fused_projection(
        args[0], None, *args[1:], w, h)
    opac = torch.as_tensor(sc["opacities"])[None].expand(2, -1).contiguous()
    T = torch.ones((2, h, w))
    jT = jnp.ones((2, h, w))
    for lo, hi, cap in ((0, 40, 1 << 14), (40, 80, 1 << 14), (0, 40, 300)):
        t = tidx.rasterize_to_indices_in_range(
            lo, hi, T, means2d, conics, opac, depths, radii, w, h,
            tile_size=8, out_capacity=cap)
        j = jidx.rasterize_to_indices_in_range(
            lo, hi, jT, *(jnp.asarray(x.numpy()) for x in (
                means2d, conics, opac, depths, radii)), w, h,
            tile_size=8, out_capacity=cap)
        for a, b in zip(t[:4], j[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(t[3]) > 0
        _close(t[4], j[4], rtol=1e-5, atol=1e-5)
        if cap > 300:  # the batches chain: the next one starts from here
            T, jT = t[4], j[4]
