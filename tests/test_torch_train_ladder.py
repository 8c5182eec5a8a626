"""The garden-ladder recipe (MCMC, the compression simulation with the
entropy models and the shN mask, opacity and scale regularisers,
grad_dtype="bf16") in gscodec_studio_tpu_torch's Runner against the JAX
package's Runner on tests/test_trainer.py's FakeParser scene, and one
Runner2DGS step under MCMC. The JAX side runs its Pallas kernels in
interpret mode. Both start from the same splats and sim parameters (the
JAX ones, carried across by models.splats' converters); every random draw
of the JAX runner (its view order, each step's position noise, each
refine's relocation sources) is handed to the port through spies, as
tests/test_torch_train.py hands over the view order. The entropy and mask
gates are opened from step 0 in both, so that every term of the recipe
carries gradient.

Tolerances:
  * one step: the loss rtol 1e-6; every parameter within 1e-6 relative or
    absolute (Adam's first step moves a parameter by about lr * sign of
    its gradient, which the packed bf16 rows keep); the sim parameters
    within 1e-6, and those whose gradient is rounding noise at the models'
    constant initial matrices (test_torch_compression_sim) only in sign
    of their move;
  * a 24-step run of the 30,000-step schedule: each step's loss within
    1e-3 relative of JAX's (the packed rows and the f32 orders of the two
    packages drift apart slowly), the allocated count after each refine
    equal;
  * one Runner2DGS step: as one Runner step.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.strategy import MCMCStrategy as JMCMCStrategy
from gscodec_studio_tpu.strategy import ops as jops
from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu.training.trainer_2dgs import Config2DGS as JConfig2
from gscodec_studio_tpu.training.trainer_2dgs import Runner2DGS as JRunner2
from gscodec_studio_tpu_torch.models.splats import (from_jax_mcmc_state,
                                                    from_jax_sim_params)
from gscodec_studio_tpu_torch.strategy import ops as tops
from gscodec_studio_tpu_torch.training.trainer import Config, Runner
from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                            Runner2DGS)

from tests.test_torch_train import (NAMES, _to_torch, fake_scene,  # noqa
                                    one_torch_thread, spy_jax_view_orders)

RECIPE = dict(strategy="mcmc", mcmc_cap_max=256, isect_capacity=8192,
              opacity_reg=0.01, scale_reg=0.01, compression_sim=True,
              entropy_model_opt=True, shN_ada_mask_opt=True, rd_lambda=0.01,
              grad_dtype="bf16", sh_degree=0, sh_degree_interval=1,
              refine_start_iter=5, refine_every=10, steps_per_dispatch=1,
              save_steps=(), tb_every=0, skip_probe=False, max_steps=30_000)
STEPS = 24


def spy_jax_mcmc_draws(monkeypatch):
    """Records the JAX package's MCMC draws, in the order drawn: each
    step's position noise, each refine's relocation sources, and the
    allocated count after each refine."""
    draws = {"noise": [], "sampled": [], "allocated": []}
    noise_fn, reloc_fn = jops.inject_noise_to_position, jops.relocate_dead
    refine_fn = JMCMCStrategy.refine

    def record(name):
        return lambda x: draws[name].append(np.array(x))

    def noise_spy(params, key, lr, *a, **kw):
        jax.debug.callback(record("noise"),
                           jax.random.normal(key, params["means"].shape))
        return noise_fn(params, key, lr, *a, **kw)

    def reloc_spy(params, opt_states, key, dead, *a, **kw):
        op = jax.nn.sigmoid(params["opacities"])
        logits = jnp.where(~dead, jnp.log(jnp.clip(op, 1e-12, 1.0)),
                           -jnp.inf)
        jax.debug.callback(record("sampled"), jax.random.categorical(
            key, logits, shape=(op.shape[0],)))
        return reloc_fn(params, opt_states, key, dead, *a, **kw)

    def refine_spy(self, *args):
        out = refine_fn(self, *args)
        jax.debug.callback(record("allocated"), out[2]["allocated"].sum())
        return out

    monkeypatch.setattr(jops, "inject_noise_to_position", noise_spy)
    monkeypatch.setattr(jops, "relocate_dead", reloc_spy)
    monkeypatch.setattr(JMCMCStrategy, "refine", refine_spy)
    return draws


def hand_over_draws(monkeypatch, runner, draws):
    """Makes the port's runner take the recorded JAX draws in order."""
    noise, sampled = iter(draws["noise"]), iter(draws["sampled"])
    monkeypatch.setattr(runner, "_position_noise",
                        lambda shape: torch.as_tensor(next(noise)))
    monkeypatch.setattr(tops, "sample_sources",
                        lambda *a, **kw: torch.as_tensor(next(sampled)))


def open_gates(sim):
    sim.entropy_steps = {k: -1 for k in sim.entropy_steps}
    sim.ada_mask_start = -1


def _jax_ladder(scene, path, monkeypatch):
    parser, trainset, valset = scene
    import gscodec_studio_tpu.ops.raster_v2 as jraster

    # one tile per grid step: the same result, a faster interpret compile
    monkeypatch.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
        jraster.rasterize_to_pixels_v2, tiles_per_step=1))
    jr = JRunner(JConfig(rasterizer="fused", result_dir=str(path), **RECIPE),
                 parser=parser, trainset=trainset, valset=valset)
    jr.splats["scales"] = jr.splats["scales"] + jnp.asarray(
        np.random.default_rng(1).normal(0, 0.3, jr.splats["scales"].shape)
        .astype(np.float32))
    open_gates(jr.compression_sim)
    init = dict(splats={k: np.array(v) for k, v in jr.splats.items()},
                sim=jax.tree_util.tree_map(np.array, jr.sim_params),
                state=jax.tree_util.tree_map(np.array, jr.strategy_state))
    return jr, init


def _port_ladder(scene, path, init):
    parser, trainset, valset = scene
    tr = Runner(Config(result_dir=str(path), **RECIPE),
                parser=parser, trainset=trainset, valset=valset,
                device="cpu")
    open_gates(tr.compression_sim)
    tr.splats = _to_torch(init["splats"])
    tr.sim_params = from_jax_sim_params(init["sim"], device="cpu")
    tr.strategy_state = from_jax_mcmc_state(init["state"], device="cpu")
    return tr


@pytest.fixture(scope="module")
def jax_runs(fake_scene, tmp_path_factory):  # noqa: F811
    """The JAX ladder Runner after one step and over STEPS steps, with its
    view orders and MCMC draws."""
    path = tmp_path_factory.mktemp("jax_ladder")
    mp = pytest.MonkeyPatch()
    try:
        orders = spy_jax_view_orders(mp)
        draws = spy_jax_mcmc_draws(mp)
        jr1, init = _jax_ladder(fake_scene, path / "one", mp)
        loss1 = jr1.train(1, log_every=0)
        one = dict(loss=loss1, draws={k: list(v) for k, v in draws.items()},
                   splats={k: np.array(v) for k, v in jr1.splats.items()},
                   sim=from_jax_sim_params(
                       jax.tree_util.tree_map(np.array, jr1.sim_params),
                       device="cpu"))
        for v in draws.values():
            v.clear()
        jr2, _ = _jax_ladder(fake_scene, path / "run", mp)
        jr2.splats = {k: jnp.asarray(v) for k, v in init["splats"].items()}
        losses = jr2.train(STEPS, log_every=0)
        skipped = getattr(jr2, "_skipped_steps", 0)
    finally:
        mp.undo()
    return dict(init=init, one=one, losses=losses, draws=draws,
                orders=orders, skipped=skipped)


def test_ladder_step_matches_jax(fake_scene, jax_runs, tmp_path,  # noqa: F811
                                 monkeypatch):
    one = jax_runs["one"]
    tr = _port_ladder(fake_scene, tmp_path, jax_runs["init"])
    assert tr.view_order == jax_runs["orders"][0]
    assert len(one["draws"]["noise"]) == 1
    hand_over_draws(monkeypatch, tr, one["draws"])
    tloss = tr.train(1, log_every=0)
    assert tloss[0] == pytest.approx(one["loss"][0], rel=1e-6)
    for k in NAMES:
        a, b = tr.splats[k].numpy(), one["splats"][k]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
    init = from_jax_sim_params(jax_runs["init"]["sim"], device="cpu")
    for k, ref in one["sim"].items():
        got = tr.sim_params[k]
        if ".matrices." in k:  # rounding-noise gradients: the move's sign
            moved = torch.sign(got - init[k]) * torch.sign(ref - init[k])
            assert float((moved >= 0).float().mean()) >= 0.9, k
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert tr.skipped_steps == 0


def test_ladder_run_tracks_jax(fake_scene, jax_runs, tmp_path,  # noqa: F811
                               monkeypatch):
    tr = _port_ladder(fake_scene, tmp_path, jax_runs["init"])
    assert tr.view_order == jax_runs["orders"][1]
    hand_over_draws(monkeypatch, tr, jax_runs["draws"])
    losses = tr.train(STEPS, log_every=0)
    np.testing.assert_allclose(losses, jax_runs["losses"], rtol=1e-3)
    allocated = [e["allocated"] for e in tr.events if e["event"] == "refine"]
    assert allocated == [int(a) for a in jax_runs["draws"]["allocated"]]
    assert allocated == [126, 133]  # ceil(1.05 n) from the 120 points
    assert tr.skipped_steps == jax_runs["skipped"] == 0
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_runner2dgs_mcmc_step_matches_jax(fake_scene, tmp_path,  # noqa: F811
                                          monkeypatch):
    """One Runner2DGS step at strategy="mcmc": no position noise in either
    package (the JAX Runner2DGS never calls inject_noise)."""
    parser, trainset, valset = fake_scene
    orders = spy_jax_view_orders(monkeypatch)
    draws = spy_jax_mcmc_draws(monkeypatch)
    kw = dict(strategy="mcmc", mcmc_cap_max=256, isect_capacity=8192,
              sh_degree=0, normal_start_iter=-1, dist_start_iter=-1,
              rasterizer="reference", max_steps=1, steps_per_dispatch=1)
    jr = JRunner2(JConfig2(result_dir=str(tmp_path / "j"), **kw),
                  parser=parser, trainset=trainset, valset=valset)
    init = {k: np.array(v) for k, v in jr.splats.items()}
    jloss = jr.train(log_every=0)
    assert draws["noise"] == []
    tr = Runner2DGS(Config2DGS(result_dir=str(tmp_path / "t"), **kw),
                    parser=parser, trainset=trainset, valset=valset,
                    device="cpu")
    tr.splats = _to_torch(init)
    assert tr.view_order == orders[0]
    monkeypatch.setattr(tr, "_position_noise", None)  # never drawn
    tloss = tr.train(log_every=0)
    assert tloss[0] == pytest.approx(jloss[0], rel=1e-6)
    for k in NAMES:
        np.testing.assert_allclose(tr.splats[k].numpy(),
                                   np.asarray(jr.splats[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tr.strategy_state["allocated"].numpy(),
                                  np.asarray(jr.strategy_state["allocated"]))
