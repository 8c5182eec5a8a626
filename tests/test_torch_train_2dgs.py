"""gscodec_studio_tpu_torch's 2DGS trainer against the JAX package on the
CPU: one Runner2DGS step, a same-seed run of a few dozen steps, the fused
and reference backends against each other, the unported options, and the
JAX runner's splats carried across. Both runners use tests/test_trainer.py's
FakeParser scene, start from the same anisotropic splats (with isotropic
scales the quaternion gradient is rounding noise that Adam's first step
turns into +-lr), open the normal and distortion gates from the first step,
and train on the oracle backend ("reference"): the JAX fused path runs in
interpret mode, too slow for a run here.

Tolerances:
  * one step: the loss within 1e-6 relative, every parameter within 1e-5
    (both sum in float32, in another order);
  * the run: every loss within 1e-4 relative of the JAX run's; Adam turns
    gradient rounding into parameter differences of ~lr * 1e-6 per step;
  * fused against reference, port only: the loss within 1e-5 relative,
    every gradient within 1e-4 of its largest |value|;
  * the JAX runner's splats through models.splats.from_jax_splats: the
    parameters bit for bit, the reference render within 1e-4 absolute
    (test_torch_2dgs's bound for the two oracles).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.models.splats import (
    splat_activations as jactivations)
from gscodec_studio_tpu.rendering import (
    rasterization_2dgs as jrasterization_2dgs)
from gscodec_studio_tpu.training.trainer_2dgs import Config2DGS as JConfig
from gscodec_studio_tpu.training.trainer_2dgs import Runner2DGS as JRunner
from gscodec_studio_tpu_torch.models.splats import (from_jax_splats,
                                                    splat_activations)
from gscodec_studio_tpu_torch.rendering import rasterization_2dgs
from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                            Runner2DGS)

from tests.test_torch_train import (NAMES, _to_torch, fake_scene,  # noqa
                                    one_torch_thread, spy_jax_view_orders)

STEPS = 24
KW = dict(capacity=256, isect_capacity=8192, sh_degree=0,
          sh_degree_interval=1, normal_start_iter=-1, dist_start_iter=-1,
          refine_start_iter=5, refine_every=10, rasterizer="reference")


def _jax_runner(scene, path, max_steps, init=None):
    parser, trainset, valset = scene
    jr = JRunner(JConfig(result_dir=str(path), max_steps=max_steps,
                         steps_per_dispatch=1, **KW),
                 parser=parser, trainset=trainset, valset=valset)
    if init is None:
        init = dict(jr.splats)
        init["scales"] = init["scales"] + jnp.asarray(
            np.random.default_rng(1).normal(0, 0.3, (256, 3)).astype(
                np.float32))
        init = {k: np.asarray(v) for k, v in init.items()}
    jr.splats = {k: jnp.asarray(v) for k, v in init.items()}
    return jr, init


@pytest.fixture(scope="module")
def jax_runs(fake_scene, tmp_path_factory):  # noqa: F811
    """The JAX Runner2DGS after one step, and its losses over STEPS steps
    from the same splats, with the view order each train() drew."""
    path = tmp_path_factory.mktemp("jax_2dgs")
    mp = pytest.MonkeyPatch()
    try:
        orders = spy_jax_view_orders(mp)
        jr1, init = _jax_runner(fake_scene, path / "one", 1)
        loss1 = jr1.train(log_every=0)
        jr2, _ = _jax_runner(fake_scene, path / "run", STEPS, init)
        losses = jr2.train(log_every=0)
    finally:
        mp.undo()
    return dict(init=init, loss1=loss1, splats1={
        k: np.asarray(v) for k, v in jr1.splats.items()}, losses=losses,
        orders=orders)


def _port_runner(scene, path, max_steps, init, **kw):
    parser, trainset, valset = scene
    cfg = Config2DGS(result_dir=str(path), max_steps=max_steps,
                     steps_per_dispatch=1, **dict(KW, **kw))
    tr = Runner2DGS(cfg, parser=parser, trainset=trainset, valset=valset,
                    device="cpu")
    tr.splats = _to_torch(init)
    return tr


def test_runner2dgs_step_matches_jax(fake_scene,  # noqa: F811
                                     jax_runs, tmp_path):
    tr = _port_runner(fake_scene, tmp_path, 1, jax_runs["init"])
    assert jax_runs["orders"][0] == tr.view_order  # C1: the same views
    tloss = tr.train(log_every=0)
    assert tloss[0] == pytest.approx(jax_runs["loss1"][0], rel=1e-6)
    init = jax_runs["init"]
    for k in NAMES:
        a, b = tr.splats[k].numpy(), jax_runs["splats1"][k]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=k)
        assert b.size == 0 or np.abs(b - init[k]).max() > 0, k
    # the strategy reads a zero means2d gradient, as the JAX runner's does
    assert not tr.strategy_state["grad2d"].any()
    assert int(tr.strategy_state["count"].sum()) > 0
    assert tr.skipped_steps == 0


def test_runner2dgs_run_tracks_jax(fake_scene,  # noqa: F811
                                   jax_runs, tmp_path):
    tr = _port_runner(fake_scene, tmp_path, STEPS, jax_runs["init"])
    assert jax_runs["orders"][1] == tr.view_order
    losses = tr.train(log_every=0)
    ref = np.asarray(jax_runs["losses"])
    assert len(losses) == len(ref) == STEPS
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert [e["step"] for e in tr.events if e["event"] == "refine"] == \
        [10, 20]
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
    assert tr.skipped_steps == 0


def test_fused_and_reference_steps_agree(fake_scene,  # noqa: F811
                                        jax_runs, tmp_path):
    """The port's two 2DGS backends on one step's loss and gradients: the
    fused path (plain tile kernels, unpack, segment sums) against the
    oracle."""
    out = {}
    for backend in ("fused", "reference"):
        tr = _port_runner(fake_scene, tmp_path / backend, 1,
                          jax_runs["init"], rasterizer=backend)
        data = tr._device_trainset()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in tr.splats.items()}
        loss, meta, _ = tr.render_loss(
            params, data["camtoworld"][:1], data["K"][:1],
            data["image"][:1], 0, 0)
        grads = torch.autograd.grad(loss, [params[k] for k in NAMES])
        out[backend] = (float(loss.detach()), grads, meta)
    assert int(out["fused"][2]["n_isects"]) > 0
    assert out["fused"][0] == pytest.approx(out["reference"][0], rel=1e-5)
    for k, a, b in zip(NAMES, out["fused"][1], out["reference"][1]):
        if b.numel() == 0:  # shN at SH degree 0
            continue
        scale = float(b.abs().max())
        assert scale > 0, k
        assert float((a - b).abs().max()) <= 1e-4 * scale, k


def test_jax_splats_render_identically(jax_runs):
    """The JAX Runner2DGS's splats (after a step) carried through
    from_jax_splats render as they do in the JAX package."""
    splats = jax_runs["splats1"]
    model = from_jax_splats(splats, device="cpu")
    for k in NAMES:
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(),
                                      splats[k].reshape(
                                          getattr(model, k).shape))
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 4.0
    K = np.array([[[58, 0, 32], [0, 58, 24], [0, 0, 1]]], np.float32)
    with torch.no_grad():
        means, quats, scales, opac = splat_activations(model)
        got = rasterization_2dgs(means, quats, scales, opac,
                                 model.sh_coeffs(), vm[None], K, 64, 48,
                                 sh_degree=0, rasterizer="reference",
                                 device="cpu")
    jm, jq, js, jo = jactivations({k: jnp.asarray(v)
                                   for k, v in splats.items()})
    colors = jnp.concatenate([splats["sh0"], splats["shN"]], 1)
    ref = jrasterization_2dgs(jm, jq, js, jo, colors, jnp.asarray(vm[None]),
                              jnp.asarray(K), 64, 48, sh_degree=0,
                              rasterizer="reference")
    assert float(got[1].mean()) > 0.05
    for a, b in zip(got[:6], ref[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("field,value", [("compression_sim", True)])
def test_unported_options_raise_2dgs(field, value, tmp_path):
    cfg = dataclasses.replace(Config2DGS(result_dir=str(tmp_path)),
                              **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Runner2DGS(cfg, parser=object(), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("attr_dtype", "bf16"), ("log_composite", True)])
def test_precision_options_named_as_ignored_2dgs(fake_scene,  # noqa: F811
                                                 field, value, tmp_path,
                                                 capsys):
    """The JAX Runner2DGS passes neither option to its render; the port's
    takes them, ignores them as JAX does and names them once."""
    parser, trainset, valset = fake_scene
    cfg = dataclasses.replace(Config2DGS(result_dir=str(tmp_path),
                                         capacity=256), **{field: value})
    Runner2DGS(cfg, parser=parser, trainset=trainset, valset=valset,
               device="cpu")
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Runner2DGS: ignored")]
    assert field in line


def test_config2dgs_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config2DGS)}
    assert tf == jf
