"""The rest of the garden recipe in gscodec_studio_tpu_torch's Runner
against the JAX package's Runner on tests/test_trainer.py's FakeParser
scene: SelectiveAdam (visible_adam) with the hash-grid entropy model
(entropy_model_type="gaussian_model") under MCMC, checkpoints in both
directions, the committed JAX checkpoint, and run_compression("png").
The JAX side runs its Pallas kernels in interpret mode. Both runners start
from the same splats and sim parameters; every random draw of the JAX
runner (view order, position noise, relocation sources and the hash-grid
model's subsample) is handed to the port, as in
tests/test_torch_train_ladder.py.

Tolerances:
  * the recipe run: each step's loss within 1e-4 relative of JAX's (the
    rd term's bits divide by likelihoods, which amplify the packages'
    float32 orders; tests/test_torch_hash_grid.py), and the rows that
    SelectiveAdam left unseen, by their zero first moments, equal;
  * checkpoints, the committed one and the port's in the JAX runner, bit
    for bit;
  * run_compression: PSNR within 0.1 dB of JAX's (the shN k-means
    differs in a few labels; test_torch_codec), size_bytes within 10%.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.compression import native as jnative
from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.compression import native as tnative
from gscodec_studio_tpu_torch.compression_sim import simulation as tsim
from gscodec_studio_tpu_torch.models.splats import (from_jax_mcmc_state,
                                                    from_jax_sim_params)
from gscodec_studio_tpu_torch.training.trainer import Config, Runner

from tests.test_torch_train import (NAMES, _to_torch, fake_scene,  # noqa
                                    spy_jax_view_orders)
from tests.test_torch_train_ladder import (hand_over_draws,
                                           spy_jax_mcmc_draws)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "results" / "garden_ab_f32" / "ckpts" / "ckpt_750.npz"
RECIPE = dict(strategy="mcmc", mcmc_cap_max=256, isect_capacity=8192,
              opacity_reg=0.01, scale_reg=0.01, compression_sim=True,
              entropy_model_opt=True, entropy_model_type="gaussian_model",
              shN_ada_mask_opt=True, visible_adam=True, rd_lambda=0.01,
              sh_degree=0, sh_degree_interval=1, refine_start_iter=2,
              refine_every=3, steps_per_dispatch=1, save_steps=(),
              tb_every=0, skip_probe=False, max_steps=30_000)
STEPS = 5
GATE = 1  # the entropy and mask gates: their terms from the 0-based step 2


def set_gates(sim):
    sim.entropy_steps = {k: GATE for k in sim.entropy_steps}
    sim.ada_mask_start = GATE


def spy_jax_subsamples(monkeypatch, draws):
    """Records each jax.random.randint draw (the hash-grid model's
    subsample; the JAX step draws nothing else with it) into draws."""
    randint = jax.random.randint

    def spy(*args, **kw):
        out = randint(*args, **kw)
        jax.debug.callback(lambda x: draws.append(np.array(x)), out)
        return out

    monkeypatch.setattr(jax.random, "randint", spy)


@pytest.fixture(scope="module")
def jax_recipe(fake_scene, tmp_path_factory):  # noqa: F811
    """The JAX recipe Runner over STEPS steps, its initial state, losses
    and draws."""
    parser, trainset, valset = fake_scene
    import gscodec_studio_tpu.ops.raster_v2 as jraster

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
            jraster.rasterize_to_pixels_v2, tiles_per_step=1))
        orders = spy_jax_view_orders(mp)
        draws = spy_jax_mcmc_draws(mp)
        draws["subsample"] = []
        spy_jax_subsamples(mp, draws["subsample"])
        jr = JRunner(JConfig(rasterizer="fused", result_dir=str(
            tmp_path_factory.mktemp("jax_recipe")), **RECIPE),
            parser=parser, trainset=trainset, valset=valset)
        jr.splats["scales"] = jr.splats["scales"] + jnp.asarray(
            np.random.default_rng(1).normal(0, 0.3, jr.splats["scales"]
                                            .shape).astype(np.float32))
        set_gates(jr.compression_sim)
        init = dict(splats={k: np.array(v) for k, v in jr.splats.items()},
                    sim=jax.tree_util.tree_map(np.array, jr.sim_params),
                    state=jax.tree_util.tree_map(np.array,
                                                 jr.strategy_state))
        losses = jr.train(STEPS, log_every=0)
    finally:
        mp.undo()
    return dict(runner=jr, init=init, losses=losses, draws=draws,
                orders=orders)


def _port_runner(scene, path, init, **over):
    parser, trainset, valset = scene
    tr = Runner(Config(result_dir=str(path), **dict(RECIPE, **over)),
                parser=parser, trainset=trainset, valset=valset,
                device="cpu")
    set_gates(tr.compression_sim)
    tr.splats = _to_torch(init["splats"])
    tr.sim_params = from_jax_sim_params(init["sim"], device="cpu")
    tr.strategy_state = from_jax_mcmc_state(init["state"], device="cpu")
    return tr


def test_recipe_run_tracks_jax(fake_scene, jax_recipe, tmp_path,  # noqa
                               monkeypatch):
    draws = jax_recipe["draws"]
    assert len(draws["subsample"]) == 3 * STEPS  # every step, gated or not
    tr = _port_runner(fake_scene, tmp_path, jax_recipe["init"])
    assert tr.view_order == jax_recipe["orders"][0]
    hand_over_draws(monkeypatch, tr, draws)
    subsample = iter(draws["subsample"])
    monkeypatch.setattr(tsim, "sample_subset",
                        lambda *a, **kw: torch.as_tensor(next(subsample)))
    losses = tr.train(STEPS, log_every=0)
    np.testing.assert_allclose(losses, jax_recipe["losses"], rtol=1e-4)
    assert tr.skipped_steps == 0
    jr = jax_recipe["runner"]
    for k in NAMES:
        seen = (tr.opt_states[k]["exp_avg"] != 0).reshape(
            tr.splats[k].shape[0], -1).any(1).numpy()
        jseen = (np.asarray(jr.opt_states[k].mu) != 0).reshape(
            seen.shape[0], -1).any(1)
        np.testing.assert_array_equal(seen, jseen, err_msg=k)
        if tr.splats[k].numel():  # shN is empty at SH degree 0
            assert 0 < seen.sum() < seen.size, k
        assert tr.opt_states[k]["count"] == int(jr.opt_states[k].count)
    # the port's checkpoint, read by the JAX runner, bit for bit
    path = tr.save_checkpoint(STEPS)
    assert jr.load_checkpoint(path) == STEPS
    back = from_jax_sim_params(jax.tree_util.tree_map(np.array,
                                                      jr.sim_params),
                               device="cpu")
    assert sorted(back) == sorted(tr.sim_params)
    for k, v in tr.sim_params.items():
        assert torch.equal(back[k], v), k
    for k in NAMES:
        np.testing.assert_array_equal(np.asarray(jr.splats[k]),
                                      tr.splats[k].numpy(), err_msg=k)


def test_committed_checkpoint_loads_as_in_jax(fake_scene,  # noqa: F811
                                              tmp_path):
    parser, trainset, valset = fake_scene
    kw = dict(strategy="mcmc", mcmc_cap_max=120_000, compression_sim=True,
              entropy_model_opt=True, shN_ada_mask_opt=True, save_steps=(),
              tb_every=0, skip_probe=False)
    jr = JRunner(JConfig(result_dir=str(tmp_path / "jax"), **kw),
                 parser=parser, trainset=trainset, valset=valset)
    tr = Runner(Config(result_dir=str(tmp_path / "port"), **kw),
                parser=parser, trainset=trainset, valset=valset,
                device="cpu")
    assert jr.load_checkpoint(str(CKPT)) == tr.load_checkpoint(str(CKPT)) \
        == 750
    for k in NAMES:
        np.testing.assert_array_equal(tr.splats[k].numpy(),
                                      np.asarray(jr.splats[k]), err_msg=k)
    want = from_jax_sim_params(jax.tree_util.tree_map(np.array,
                                                      jr.sim_params),
                               device="cpu")
    assert len(want) == len(tr.sim_params) == 28
    for k, v in want.items():
        assert torch.equal(tr.sim_params[k], v), k
    with np.load(CKPT) as z:
        assert np.array_equal(tr.sim_params["ada_mask"].numpy(), z["sim/0"])


def test_hash_grid_checkpoint_round_trip(fake_scene, tmp_path):  # noqa
    """A gaussian_model run saves at its save_steps; a saved checkpoint
    reloads into a fresh Runner with the same bits, and a runner of
    another configuration refuses it."""
    parser, trainset, valset = fake_scene
    cfg = Config(result_dir=str(tmp_path), **dict(
        RECIPE, save_steps=(2,), isect_capacity=8192))
    tr = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                device="cpu")
    set_gates(tr.compression_sim)
    tr.train(3, log_every=0)
    assert (tmp_path / "ckpts" / "ckpt_2.npz").exists()
    path = tr.save_checkpoint(3)
    fresh = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                   device="cpu")
    assert fresh.load_checkpoint(path) == 3
    for k in NAMES:
        assert torch.equal(fresh.splats[k], tr.splats[k]), k
    for k, v in tr.sim_params.items():
        assert torch.equal(fresh.sim_params[k], v), k
    other = Runner(Config(result_dir=str(tmp_path / "f"), **dict(
        RECIPE, entropy_model_type="factorized_model")), parser=parser,
        trainset=trainset, valset=valset, device="cpu")
    with pytest.raises(ValueError, match="sim/"):
        other.load_checkpoint(path)


def test_run_compression_matches_jax(fake_scene, jax_recipe, tmp_path,  # noqa
                                     monkeypatch):
    """run_compression("png") of the JAX run's trained splats in both
    packages (PLAS on one thread in both)."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "plas_sort", functools.partial(
            mod.plas_sort, n_threads=1))
    jr = jax_recipe["runner"]
    jr.cfg.result_dir = str(tmp_path / "jax")
    want = jr.run_compression(STEPS, method="png")
    splats = {k: np.array(v) for k, v in jr.splats.items()}
    tr = _port_runner(fake_scene, tmp_path / "port",
                      dict(jax_recipe["init"], splats=splats))
    got = tr.run_compression(STEPS, method="png")
    assert abs(got["psnr"] - want["psnr"]) <= 0.1
    assert got["size_bytes"] == pytest.approx(want["size_bytes"], rel=0.10)
    assert set(tr.compression_seconds) == {
        "filter", "plas", "kmeans", "png_write", "decode", "eval"}
    for k in NAMES:  # the trained splats are back
        np.testing.assert_array_equal(tr.splats[k].numpy(), splats[k])
    with pytest.raises(NotImplementedError, match="A9"):
        tr.run_compression(STEPS, method="entropy_coding")
    tr.save_ply(str(tmp_path / "scene.ply"))
    assert (tmp_path / "scene.ply").stat().st_size > 0
