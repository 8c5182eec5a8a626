"""The Runner's mesh mode against the JAX package's Runner(mesh_devices=2)
on the CPU: the port's 2 ranks are gloo processes
(tests/torch_mesh_workers.py), JAX's the devices of tests/conftest.py's 8
host devices; tests/torch_mesh_workers.MeshScene's numpy scene, the
default strategy (no noise), batch 2, the same initial splats (JAX's, its
scales made anisotropic). The first two losses within rtol 1e-5: the
second follows one Adam step of each, which the scale of the gradient
does not move."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.parallel import launcher
from tests import torch_mesh_workers as workers


def test_mesh_runner_losses_match_jax(tmp_path, monkeypatch):
    import gscodec_studio_tpu.ops.raster_v2 as jraster

    # one tile a grid step: the same result, a faster interpret compile
    monkeypatch.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
        jraster.rasterize_to_pixels_v2, tiles_per_step=1))
    scene = workers.MeshScene()
    trainset, valset = scene.split()
    cfg = workers.mesh_config(str(tmp_path / "j"), max_steps=2,
                              mesh_devices=2)
    jr = JRunner(JConfig(**{f: getattr(cfg, f) for f in (
        "result_dir", "batch_size", "sh_degree", "capacity",
        "isect_capacity", "eval_steps", "save_steps", "tb_every",
        "skip_probe", "max_steps", "mesh_devices")}), parser=scene,
        trainset=trainset, valset=valset)
    jr.splats["scales"] = jnp.asarray(np.random.default_rng(3).normal(
        -2.5, 0.4, jr.splats["scales"].shape).astype(np.float32))
    init = {k: np.asarray(v) for k, v in jr.splats.items()}
    jloss = jr.train(log_every=0)
    tloss = launcher.spawn(workers.runner_losses_ranks, 2,
                           str(tmp_path / "t"), init, 2)
    assert tloss[0] == tloss[1]
    assert tloss[0] == pytest.approx(jloss, rel=1e-5)
