"""gscodec_studio_tpu_torch.rendering.rasterization and
utils.ply_render.render_splats vs the JAX package's fused path on the CPU
(the JAX side runs its Pallas kernels in interpret mode).

Tolerance: images and alphas max abs <= 5e-3 with >= 99.9% of values
within 1e-4 (see test_torch_raster_v2); n_isects equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.rendering import rasterization as jrasterization
from gscodec_studio_tpu.utils import ply_render as jply
from gscodec_studio_tpu_torch.models.splats import from_jax_splats
from gscodec_studio_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref
from gscodec_studio_tpu_torch.rendering import (project_and_shade,
                                                rasterization)
from gscodec_studio_tpu_torch.utils import ply_render as tply

from tests.conftest import make_test_scene
from tests.test_torch_raster_v2 import assert_images_close

CHECKPOINT = (Path(__file__).resolve().parents[1] / "results"
              / "garden_ab_f32" / "splats_final.npz")


@pytest.mark.parametrize(
    "mode,sh_degree,antialiased,use_bg,cutoff",
    [("RGB", 3, False, True, "exact"), ("D", None, True, False, "exact"),
     ("ED", None, False, False, "exact"), ("RGB+D", 2, True, True, "exact"),
     ("RGB+ED", None, False, True, "soft")],
)
def test_render_modes_match_jax(rng, mode, sh_degree, antialiased, use_bg,
                                cutoff):
    W, H = 96, 64
    sc = make_test_scene(rng, C=2, N=700, width=W, height=H)
    N = 700
    colors = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32) \
        if sh_degree is not None else rng.random((N, 3)).astype(np.float32)
    bg = rng.random((2, 3)).astype(np.float32) if use_bg else None
    names = ("means", "quats", "scales", "opacities")
    args = [sc[k] for k in names] + [colors, sc["viewmats"], sc["Ks"]]
    kw = dict(sh_degree=sh_degree, render_mode=mode, isect_capacity=16384,
              rasterize_mode="antialiased" if antialiased else "classic",
              cutoff_mode=cutoff)
    img_j, alp_j, meta_j = jax.jit(lambda bg_, *a: jrasterization(
        *a, W, H, backgrounds=bg_, rasterizer="fused", **kw))(
        None if bg is None else jnp.asarray(bg), *map(jnp.asarray, args))
    img, alp, meta = rasterization(*args, W, H, backgrounds=bg,
                                   device="cpu", **kw)
    assert img.shape == img_j.shape
    assert int(meta["n_isects"][0]) == int(meta_j["n_isects"]) > 0
    assert_images_close(img, img_j)
    assert_images_close(alp, alp_j)


def test_wide_channels_bin_per_128_and_match_oracle(rng):
    """Above 128 channels rasterization loops over 128-channel chunks; the
    result matches the port's dense oracle on the same projected inputs."""
    W, H, N, D = 64, 48, 300, 130
    sc = make_test_scene(rng, C=1, N=N, width=W, height=H)
    colors = rng.random((N, D)).astype(np.float32)
    img, alp, meta = rasterization(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], colors,
        sc["viewmats"], sc["Ks"], W, H, isect_capacity=8192, device="cpu")
    assert img.shape == (1, H, W, D)
    args = [torch.as_tensor(sc[k]) for k in
            ("means", "quats", "scales", "opacities")]
    radii, means2d, depths, conics, cols, opac, _ = project_and_shade(
        *args, torch.as_tensor(colors), torch.as_tensor(sc["viewmats"]),
        torch.as_tensor(sc["Ks"]), W, H)
    ref, ref_a = rasterize_to_pixels_ref(means2d, conics, cols, opac, depths,
                                         radii, W, H, 16)
    assert_images_close(img, ref)
    assert_images_close(alp, ref_a)


def test_render_splats_matches_jax_on_checkpoint():
    with np.load(CHECKPOINT) as z:
        splats = {k: z[k][:2000] for k in z.files}
    cams = jply.orbit_cameras(splats["means"], n_views=2, width=96,
                              height=64)
    cams_t = tply.orbit_cameras(splats["means"], n_views=2, width=96,
                                height=64)
    for a, b in zip(cams, cams_t):
        np.testing.assert_array_equal(a["camtoworld"], b["camtoworld"])
        np.testing.assert_array_equal(a["K"], b["K"])
    ref = jply.render_splats(splats, cams, isect_capacity=1 << 16,
                             rasterizer="fused")
    out = tply.render_splats(from_jax_splats(splats, device="cpu"), cams_t,
                             isect_capacity=1 << 16)
    assert len(out) == len(ref)
    for (rgb, alpha, meta), r in zip(out, ref):
        assert int(meta["n_isects"][0]) > 0
        assert float(alpha.mean()) > 0.05
        assert_images_close(rgb, r)
