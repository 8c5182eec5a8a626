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
from gscodec_studio_tpu_torch.ops.raster_v2_2dgs import (
    rasterize_to_pixels_2dgs_v2)
from gscodec_studio_tpu_torch.rendering import (rasterization,
                                                rasterization_2dgs)
from gscodec_studio_tpu_torch.training.trainer import Config, Runner
from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                            Runner2DGS)
from gscodec_studio_tpu_torch.utils.scenes import (checkpoint_stand_in,
                                                   make_scene)

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
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'gscodec_studio_tpu']\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    pkg = "gscodec_studio_tpu_torch."
    assert {pkg + m for m in (
        "ops.raster_v2", "rendering", "models.splats",
        "optimizers.builders", "strategy.base", "strategy.ops",
        "strategy.default", "training.losses", "training.trainer",
        "utils.scenes", "ops.projection_2dgs", "ops.rasterize_ref_2dgs",
        "ops.raster_v2_2dgs", "training.trainer_2dgs", "ops.isect",
        "ops.rasterize_pallas", "profiling.kernel_skel_bench",
        "datasets.colmap_io", "datasets.normalize", "datasets.colmap",
        "datasets.traj", "utils.camera_opt", "utils.bilagrid",
        "utils.logger", "utils.cli", "simple_trainer", "models.temporal",
        "strategy.stg", "training.dyn_trainer", "datasets.invr",
        "datasets.stg_readers", "compression.seq_codec",
        "compression.stg_compression", "compression.hevc_compression",
        "compression.ges_tm", "utils.mv_preprocess", "dyn_trainer_cli",
        "compress_ply_sequence", "parallel", "parallel.distributed",
        "parallel.launcher", "parallel.dryrun", "training.lpips",
        "utils.viewer", "ply_loader_renderer", "simple_viewer",
        "image_fitting", "ges_tm_anchor", "exchange_cap_sweep")} <= walked


def test_entry_points_default_to_cuda(rng, monkeypatch, tmp_path):
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
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterization_2dgs(d["means"], d["quats"], np.exp(d["scales"]),
                           np.full(10, 0.5, np.float32), col[0], vm, K, 48,
                           32)
    M = np.tile(np.eye(3, dtype=np.float32), (1, 10, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_to_pixels_2dgs_v2(m2, M, col, op, col, dep, rad, 48, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsplats.create_splats(d["means"])
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint_stand_in(ROOT / "results" / "garden_ab_f32"
                            / "splats_final.npz", n_views=1)

    class Parser:
        points = d["means"]
        points_rgb = np.full((10, 3), 128.0, np.float32)

    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(Config(result_dir=str(tmp_path)), parser=Parser(),
               trainset=[], valset=[])
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner2DGS(Config2DGS(result_dir=str(tmp_path)), parser=Parser(),
                   trainset=[], valset=[])


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
    # One thread: with several, torch's CPU kernels may round an alpha
    # differently from one process to the next, and an alpha that sits on
    # the 1/255 threshold then drops in or out.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = rasterize_to_pixels_ref(*map(torch.as_tensor, args), W, H, 16,
                                      backgrounds=torch.as_tensor(bg),
                                      masks=torch.as_tensor(masks))
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
