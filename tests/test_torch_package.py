"""gscodec_studio_tpu_torch as a package: it imports neither JAX nor the
JAX package, its entry points default to the CUDA card and refuse to run
without one, and the splat model carries the JAX package's parameters
across unchanged."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.models import splats as jsplats
from gscodec_studio_tpu.ops.rasterize_ref import (
    rasterize_to_pixels_ref as jrasterize_ref,
)
from gscodec_studio_tpu_torch.models import splats as tsplats
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.utils.scenes import make_scene

from tests.test_rasterize_pallas import make_2d_scene

ROOT = Path(__file__).resolve().parents[1]


def _splat_dict(rng, n=300):
    return dict(
        means=rng.standard_normal((n, 3)).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=rng.normal(-10, 4, (n, 3)).astype(np.float32),
        opacities=rng.normal(0, 3, n).astype(np.float32),
        sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
        shN=rng.standard_normal((n, 15, 3)).astype(np.float32),
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gscodec_studio_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'gscodec_studio_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _splat_dict(rng, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsplats.from_jax_splats(d)
    m2, con, col, op, dep, rad, _ = make_2d_scene(rng, N=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.rasterize_to_pixels_v2(m2, con, col, op, dep, rad, 48, 32)
    vm = np.eye(4, dtype=np.float32)[None]
    K = np.array([[[40, 0, 24], [0, 40, 16], [0, 0, 1]]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterization(d["means"], d["quats"], np.exp(d["scales"]),
                      np.full(10, 0.5, np.float32), col[0], vm, K, 48, 32)


def test_from_jax_splats_round_trip(rng):
    d = _splat_dict(rng)
    model = tsplats.from_jax_splats(d, device="cpu")
    assert isinstance(model, torch.nn.Module)
    assert model.num_splats == 300 and model.sh_degree == 3
    for k, v in d.items():
        got = getattr(model, k).detach().numpy()
        np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(
        model.sh_coeffs().detach().numpy(),
        np.concatenate([d["sh0"], d["shN"]], 1))
    back = {k: getattr(model, k).detach().numpy() for k in d}
    model2 = tsplats.from_jax_splats(back, device="cpu")
    for k in d:
        assert torch.equal(getattr(model2, k), getattr(model, k))


def test_splat_activations_match_jax(rng):
    d = _splat_dict(rng)
    assert (d["scales"] < tsplats.LOG_SCALE_FLOOR).any()
    ref = jsplats.splat_activations({k: jnp.asarray(v) for k, v in d.items()})
    got = tsplats.splat_activations(tsplats.from_jax_splats(d, device="cpu"))
    assert tsplats.LOG_SCALE_FLOOR == jsplats.LOG_SCALE_FLOOR
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-30)


def test_make_scene_matches_bench():
    import bench

    ref = bench.make_scene(n=2000, width=320, height=240, seed=3)
    got = make_scene(n=2000, width=320, height=240, seed=3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_rasterize_ref_matches_jax(rng):
    W, H = 48, 32
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=2, N=150, W=W,
                                                   H=H)
    masks = rng.random((2, 2, 3)) > 0.3
    args = (m2, con, col, op, dep, rad)
    ref = jrasterize_ref(*map(jnp.asarray, args), W, H, 16,
                         backgrounds=jnp.asarray(bg),
                         masks=jnp.asarray(masks))
    got = rasterize_to_pixels_ref(*map(torch.as_tensor, args), W, H, 16,
                                  backgrounds=torch.as_tensor(bg),
                                  masks=torch.as_tensor(masks))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_backward_is_refused_until_the_training_slice(rng):
    m2, con, col, op, dep, rad, _ = make_2d_scene(rng, N=40)
    means2d = torch.tensor(m2, requires_grad=True)
    img, alp, _ = tr.rasterize_to_pixels_v2(
        means2d, con, col, op, dep, rad, 48, 32, isect_capacity=4096,
        device="cpu")
    with pytest.raises(NotImplementedError, match="backward"):
        img.sum().backward()


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
