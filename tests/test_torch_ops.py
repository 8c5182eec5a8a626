"""gscodec_studio_tpu_torch ops vs the JAX package on the CPU: quaternions,
transforms, projection and spherical harmonics. Inputs are made with numpy
from a seed and fed to both packages.

Tolerance: 1e-5 relative (atol 1e-6 of the values' scale), the float32
rounding of two elementwise chains that may order or fuse operations
differently; integer radii must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.ops import projection as jproj
from gscodec_studio_tpu.ops import quat as jquat
from gscodec_studio_tpu.ops import sh as jsh
from gscodec_studio_tpu.ops import transforms as jtf
from gscodec_studio_tpu_torch.ops import projection as tproj
from gscodec_studio_tpu_torch.ops import quat as tquat
from gscodec_studio_tpu_torch.ops import sh as tsh
from gscodec_studio_tpu_torch.ops import transforms as ttf

from tests.conftest import make_test_scene


def _close(port, ref, rtol=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-6 * scale)


def test_quat_ops_match_jax(rng):
    q = rng.standard_normal((500, 4)).astype(np.float32)
    s = np.exp(rng.normal(-2, 0.5, (500, 3))).astype(np.float32)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s)
    _close(tquat.normalize_quat(tq), jquat.normalize_quat(jnp.asarray(q)))
    _close(tquat.quat_to_rotmat(tq), jquat.quat_to_rotmat(jnp.asarray(q)))
    _close(tquat.quat_scale_to_covar(tq, ts),
           jquat.quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s)))


def test_transforms_match_jax(rng):
    sc = make_test_scene(rng, C=2, N=300)
    q = sc["quats"]
    s = sc["scales"]
    cov = np.array(jquat.quat_scale_to_covar(jnp.asarray(q),
                                               jnp.asarray(s)))
    vm = sc["viewmats"]
    _close(ttf.pos_world_to_cam(torch.as_tensor(vm),
                                torch.as_tensor(sc["means"])),
           jtf.pos_world_to_cam(jnp.asarray(vm), jnp.asarray(sc["means"])))
    _close(ttf.covar_world_to_cam(torch.as_tensor(vm), torch.as_tensor(cov)),
           jtf.covar_world_to_cam(jnp.asarray(vm), jnp.asarray(cov)))


@pytest.mark.parametrize(
    "antialiased,elliptical,with_opacity",
    [(False, False, False), (True, True, True), (False, True, True),
     (True, False, False)],
)
def test_projection_matches_jax(rng, antialiased, elliptical, with_opacity):
    sc = make_test_scene(rng, C=2, N=800, width=96, height=64)
    # a spread of opacities, some below 1/255, exercises the tight radius
    opac = (rng.random(800) ** 3).astype(np.float32)
    names = ("means", "quats", "scales", "viewmats", "Ks")
    jargs = [jnp.asarray(sc[k]) for k in names]
    targs = [torch.as_tensor(sc[k]) for k in names]
    kw = dict(calc_compensations=antialiased, elliptical=elliptical,
              near_plane=0.5, far_plane=6.0, radius_clip=0.5)
    j = jproj.fully_fused_projection(
        jargs[0], None, *jargs[1:], 96, 64,
        opacities=jnp.asarray(opac) if with_opacity else None, **kw)
    t = tproj.fully_fused_projection(
        targs[0], None, *targs[1:], 96, 64,
        opacities=torch.as_tensor(opac) if with_opacity else None, **kw)
    assert t[0].dtype == torch.int32
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    assert int((t[0] > 0).sum()) > 0
    for a, b in zip(t[1:4], j[1:4]):
        _close(a, b)
    if antialiased:
        _close(t[4], j[4])
    else:
        assert t[4] is None and j[4] is None


@pytest.mark.parametrize("model", ["ortho", "fisheye"])
def test_projection_other_cameras_not_ported(rng, model):
    sc = make_test_scene(rng, C=1, N=10)
    args = [torch.as_tensor(sc[k]) for k in
            ("means", "quats", "scales", "viewmats", "Ks")]
    with pytest.raises(NotImplementedError):
        tproj.fully_fused_projection(args[0], None, *args[1:], 64, 48,
                                     camera_model=model)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics_match_jax(rng, degree):
    dirs = rng.standard_normal((2, 300, 3)).astype(np.float32)
    coeffs = rng.standard_normal((2, 300, 25, 3)).astype(np.float32)
    masks = rng.random((2, 300)) > 0.3
    _close(tsh.sh_basis(degree, torch.as_tensor(dirs)),
           jsh.sh_basis(degree, jnp.asarray(dirs)))
    _close(
        tsh.spherical_harmonics(degree, torch.as_tensor(dirs),
                                torch.as_tensor(coeffs),
                                masks=torch.as_tensor(masks)),
        jsh.spherical_harmonics(degree, jnp.asarray(dirs),
                                jnp.asarray(coeffs), masks=jnp.asarray(masks)),
    )
