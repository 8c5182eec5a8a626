"""One training step of gscodec_studio_tpu_torch's Runner with the sorted
table's bf16 attribute rows and the log-space transmittance scan
(attr_dtype="bf16", log_composite=True, the knobs that
examples/garden_benchmark.py exposes on the ladder recipe) against the JAX
package's Runner on tests/test_trainer.py's FakeParser scene, from the
same splats and views. The JAX side runs its Pallas kernels in interpret
mode.

Tolerances: the loss rtol 1e-6; every parameter within 1e-6 relative or
absolute (Adam's first step moves a parameter by about lr * sign of its
gradient); the strategy's means2d gradient norms within 1e-4 of their
largest value and its counts equal, as in tests/test_torch_train.py.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.training.trainer import Config, Runner

from tests.test_torch_train import (NAMES, _to_torch, close,  # noqa: F401
                                    fake_scene, one_torch_thread,
                                    spy_jax_view_orders)


def test_packed_runner_step_matches_jax(fake_scene,  # noqa: F811
                                        tmp_path, monkeypatch):
    parser, trainset, valset = fake_scene
    jax_orders = spy_jax_view_orders(monkeypatch)
    # one tile per grid step: the same result, a faster interpret compile
    import gscodec_studio_tpu.ops.raster_v2 as jraster

    monkeypatch.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
        jraster.rasterize_to_pixels_v2, tiles_per_step=1))
    kw = dict(max_steps=1, capacity=256, isect_capacity=8192,
              attr_dtype="bf16", log_composite=True)
    jr = JRunner(JConfig(rasterizer="fused", result_dir=str(tmp_path / "j"),
                         **kw), parser=parser, trainset=trainset,
                 valset=valset)
    jr.splats["scales"] = jr.splats["scales"] + jnp.asarray(
        np.random.default_rng(1).normal(0, 0.3, (256, 3)).astype(np.float32))
    init = {k: np.asarray(v) for k, v in jr.splats.items()}
    jloss = jr.train(log_every=0)

    tr = Runner(Config(result_dir=str(tmp_path / "t"), **kw), parser=parser,
                trainset=trainset, valset=valset, device="cpu")
    tr.splats = _to_torch(init)
    assert len(jax_orders) == 1 and tr.view_order == jax_orders[0]
    tloss = tr.train(log_every=0)
    assert tloss[0] == pytest.approx(jloss[0], rel=1e-6)
    for k in NAMES:
        a, b = tr.splats[k].numpy(), np.asarray(jr.splats[k])
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
        assert np.abs(b - init[k]).max() > 0 or k == "shN", k
    assert close(tr.strategy_state["grad2d"], jr.strategy_state["grad2d"],
                 1e-4)
    np.testing.assert_array_equal(tr.strategy_state["count"].numpy(),
                                  np.asarray(jr.strategy_state["count"]))
    assert tr.skipped_steps == 0
