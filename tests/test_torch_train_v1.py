"""gscodec_studio_tpu_torch's Runner on the legacy v1 backend
(``Config(rasterizer="pallas")``) and on the dense oracle
(``"reference"``) against the JAX package on the CPU: one Runner step
against the JAX Runner's, a short run that raises the held-out PSNR, and
the options the Runner takes and names. Both packages' v1 cutoff is set to
"exact", the JAX tests' setting (tests/conftest.py).

Tolerances, those of tests/test_torch_train.py's fused step: the loss and
every parameter within 1e-6 relative or absolute from the same initial,
anisotropic splats; the densification statistic grad2d within 1e-4 of its
largest value (test_torch_raster_v1's gradient bound).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from gscodec_studio_tpu.ops import rasterize_pallas as jrp
from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.ops import rasterize_pallas as trp
from gscodec_studio_tpu_torch.training import trainer as ttrainer
from gscodec_studio_tpu_torch.training.trainer import Config, Runner

from tests.test_torch_train import (NAMES, _to_torch, close,  # noqa: F401
                                    fake_scene, one_torch_thread,
                                    spy_jax_view_orders)


@pytest.fixture(autouse=True)
def exact_cutoff(monkeypatch):
    for mod in (jrp, trp):
        monkeypatch.setattr(mod, "CUTOFF_MODE", "exact")


def test_runner_step_matches_jax_pallas(fake_scene, tmp_path,  # noqa: F811
                                        monkeypatch):
    parser, trainset, valset = fake_scene
    jax_orders = spy_jax_view_orders(monkeypatch)
    kw = dict(max_steps=1, capacity=256, isect_capacity=8192,
              rasterizer="pallas")
    jr = JRunner(JConfig(result_dir=str(tmp_path / "j"), **kw),
                 parser=parser, trainset=trainset, valset=valset)
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


def test_port_training_improves_psnr_pallas(fake_scene,  # noqa: F811
                                            tmp_path):
    """test_port_training_improves_psnr on the v1 backend: 40 steps on
    the CPU with two refines."""
    parser, trainset, valset = fake_scene
    cfg = Config(result_dir=str(tmp_path), max_steps=40, sh_degree=0,
                 sh_degree_interval=1, capacity=256, isect_capacity=8192,
                 refine_start_iter=10, refine_every=20, rasterizer="pallas")
    runner = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                    device="cpu")
    before = runner.eval("before")["psnr"]
    losses = runner.train(log_every=0)
    after = runner.eval("after")["psnr"]
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert after > before + 1.0, (before, after)
    refines = [e for e in runner.events if e["event"] == "refine"]
    assert [e["step"] for e in refines] == [20, 40]
    assert runner.skipped_steps == 0


@pytest.mark.parametrize("rasterizer", ["pallas", "reference"])
def test_runner_takes_the_other_backends(fake_scene, tmp_path,  # noqa: F811
                                         monkeypatch, capsys, rasterizer):
    """Refused before v1 was ported, the other backends reach the
    training render and the eval render; the absgrad probe stays off
    them (the JAX Runner's use_absgrad), and the fused backend's options
    are named once as ignored."""
    parser, trainset, valset = fake_scene
    seen = []
    plain = ttrainer.rasterization

    def spy(*args, **kw):
        seen.append((kw.get("rasterizer"), kw.get("absgrad_probe")))
        return plain(*args, **kw)

    monkeypatch.setattr(ttrainer, "rasterization", spy)
    cfg = Config(result_dir=str(tmp_path), max_steps=1, capacity=256,
                 isect_capacity=8192, rasterizer=rasterizer,
                 cutoff_mode="exact", grad_dtype="bf16")
    runner = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                    device="cpu")
    runner.strategy = dataclasses.replace(runner.strategy, absgrad=True)
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if "ignored under" in ln]
    assert rasterizer in line and "cutoff_mode" in line \
        and "grad_dtype" in line and "attr_dtype" not in line
    losses = runner.train(log_every=0)
    runner.eval("after")
    assert np.isfinite(losses).all() and runner.skipped_steps == 0
    assert [r for r, _ in seen] == [rasterizer] * 2
    assert all(p is None for _, p in seen)
    assert float(runner.strategy_state["grad2d"].abs().max()) > 0
