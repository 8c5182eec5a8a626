"""gscodec_studio_tpu_torch's training slice against the JAX package on the
CPU: losses, Adam, splat creation, the densification ops and the default
strategy, one Runner step, a short training run, and the training
stand-in. Inputs are made from seeds with numpy and fed to both packages.

Tolerances:
  * SSIM, PSNR, the combined loss and their gradients: 1e-5 of the largest
    |value| (both convolve in float32, in another order);
  * Adam over three steps: 1e-6 of each parameter's largest |value|
    (optax's arithmetic, step for step);
  * strategy ops and the default strategy: bit for bit, except the split's
    means and scales (1e-6: the rotation and exp are computed in another
    order);
  * one Runner step: loss and every parameter within 1e-6 relative or
    1e-6 absolute, from the same initial splats; the densification
    statistic grad2d (norms of the means2d gradient) within 1e-4 of its
    largest value, the raster gradients' tolerance
    (test_torch_raster_v2_bwd). Adam's first step moves a
    parameter by about lr * sign(gradient), so this holds only where the
    gradients are real: the k-NN initial scales are isotropic, which makes
    the true quaternion gradient zero and its computed value rounding
    noise, so both runners start from the same anisotropic scales.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.test_trainer as jtrainer_tests
from gscodec_studio_tpu.models import splats as jsplats
from gscodec_studio_tpu.optimizers.builders import (
    apply_updates as japply_updates,
    build_splat_optimizers as jbuild_optimizers,
)
from gscodec_studio_tpu.rendering import rasterization as jrasterization
from gscodec_studio_tpu.strategy import DefaultStrategy as JDefaultStrategy
from gscodec_studio_tpu.strategy import ops as jops
from gscodec_studio_tpu.training import losses as jlosses
from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.models import splats as tsplats
from gscodec_studio_tpu_torch.optimizers import (apply_updates,
                                                 build_splat_optimizers)
from gscodec_studio_tpu_torch.strategy import DefaultStrategy
from gscodec_studio_tpu_torch.strategy import ops as tops
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.training import losses as tlosses
from gscodec_studio_tpu_torch.training.trainer import Config, Runner
from gscodec_studio_tpu_torch.utils.scenes import checkpoint_stand_in

from tests.test_trainer import FakeDataset, FakeParser

CHECKPOINT = (Path(__file__).resolve().parents[1] / "results"
              / "garden_ab_f32" / "splats_final.npz")
NAMES = ("means", "quats", "scales", "opacities", "sh0", "shN")


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) <= tol * scale


@pytest.fixture(scope="module")
def fake_scene():
    """tests/test_trainer.py's FakeParser scene, its targets rendered by a
    jitted JAX renderer (one compile for the six views)."""
    plain = jtrainer_tests.rasterization
    jtrainer_tests.rasterization = jax.jit(
        jrasterization,
        static_argnames=("width", "height", "sh_degree", "isect_capacity"))
    try:
        parser = FakeParser(np.random.default_rng(42))
    finally:
        jtrainer_tests.rasterization = plain
    return parser, FakeDataset(parser, "train"), FakeDataset(parser, "val")


def test_losses_match_jax(rng):
    a = rng.random((2, 40, 56, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    for name, kw in (("ssim", {}), ("psnr", {}), ("l1", {}),
                     ("combined_loss", {"ssim_lambda": 0.2})):
        jf = lambda x: getattr(jlosses, name)(x, jnp.asarray(b), **kw)
        ref, gref = jax.value_and_grad(jf)(jnp.asarray(a))
        x = torch.tensor(a, requires_grad=True)
        val = getattr(tlosses, name)(x, torch.as_tensor(b), **kw)
        val.backward()
        assert abs(val.item() - float(ref)) <= 1e-5 * abs(float(ref)), name
        assert close(x.grad, gref, 1e-5), name
    assert float(tlosses.ssim(torch.as_tensor(a), torch.as_tensor(a))) \
        == pytest.approx(1.0, abs=1e-6)


def _params(rng, cap=64):
    return {
        "means": rng.standard_normal((cap, 3)).astype(np.float32),
        "quats": rng.standard_normal((cap, 4)).astype(np.float32),
        "scales": rng.normal(-3, 0.5, (cap, 3)).astype(np.float32),
        "opacities": rng.normal(0, 2, cap).astype(np.float32),
        "sh0": rng.standard_normal((cap, 1, 3)).astype(np.float32),
        "shN": rng.standard_normal((cap, 15, 3)).astype(np.float32),
    }


def _to_torch(d):
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def _moments(jstates):
    """{name: (mu, nu)} of the JAX package's optax Adam states."""
    return {k: (np.array(s[0].mu), np.array(s[0].nu))
            for k, s in jstates.items()}


def _port_states(jstates):
    return {k: {"count": int(jstates[k][0].count),
                "exp_avg": torch.as_tensor(mu),
                "exp_avg_sq": torch.as_tensor(nu)}
            for k, (mu, nu) in _moments(jstates).items()}


def test_adam_three_steps_match_jax(rng):
    p = _params(rng)
    kw = dict(scene_scale=2.5, batch_size=1, max_steps=4)
    jtx, jst = jbuild_optimizers({k: jnp.asarray(v) for k, v in p.items()},
                                 **kw)
    groups, st = build_splat_optimizers(_to_torch(p), **kw)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _to_torch(p)
    for _ in range(3):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(
            -4, 1)).astype(np.float32) for k, v in p.items()}
        jp, jst = japply_updates(jtx, jst, jp, {k: jnp.asarray(v)
                                                for k, v in g.items()})
        tp, st = apply_updates(groups, st, tp, _to_torch(g))
    for k in p:
        assert close(tp[k], jp[k], 1e-6), k
        mu, nu = _moments(jst)[k]
        assert close(st[k]["exp_avg"], mu, 1e-6), k
        assert close(st[k]["exp_avg_sq"], nu, 1e-6), k
        assert st[k]["count"] == 3
    # the means' rate decays: 0.01 ** (count / max_steps)
    assert groups["means"].lr_at(2) == pytest.approx(
        1.6e-4 * 2.5 * 0.01 ** 0.5)


def test_create_splats_match_jax(rng):
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    rgb = rng.random((50, 3)).astype(np.float32)
    ref = jsplats.create_splats(pts, rgb, cap=80, sh_degree=3,
                                init_opacity=0.2, init_scale=1.5)
    g = torch.Generator().manual_seed(0)
    got = tsplats.create_splats(pts, rgb, cap=80, sh_degree=3,
                                init_opacity=0.2, init_scale=1.5,
                                generator=g, device="cpu")
    for k in ("means", "scales", "opacities", "sh0", "shN"):
        assert close(got[k], ref[k], 1e-6), k
    q = got["quats"]
    assert q.shape == (80, 4) and bool(((q >= 0) & (q < 1)).all())
    assert tsplats.num_live(got) == int(jsplats.num_live(ref)) == 50
    np.testing.assert_allclose(
        tsplats.knn_mean_dist(pts), jsplats.knn_mean_dist(pts), rtol=1e-6)
    np.testing.assert_allclose(tsplats.sh_to_rgb(tsplats.rgb_to_sh(rgb)),
                               rgb, atol=1e-6)


def _state_with_moments(rng, p):
    """JAX optax states after one Adam step, and the same moments in the
    port's layout."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jtx, jst = jbuild_optimizers(jp)
    g = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
         for k, v in p.items()}
    jp, jst = japply_updates(jtx, jst, jp, g)
    return ({k: np.asarray(v) for k, v in jp.items()}, jst,
            _port_states(jst))


def _assert_state_equal(tp, tst, jp, jst, approx=()):
    for k in jp:
        if k in approx:
            assert close(tp[k], jp[k], 1e-6), k
        else:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                          err_msg=k)
        mu, nu = _moments(jst)[k]
        np.testing.assert_array_equal(tst[k]["exp_avg"].numpy(), mu)
        np.testing.assert_array_equal(tst[k]["exp_avg_sq"].numpy(), nu)


def test_strategy_ops_match_jax(rng):
    cap = 64
    p = _params(rng, cap)
    p["opacities"][rng.random(cap) < 0.4] = jsplats.DEAD_OPACITY_LOGIT
    p, jst, tst = _state_with_moments(rng, p)
    tp = _to_torch(p)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    alive = p["opacities"] > jsplats.DEAD_OPACITY_LOGIT + 1.0
    want = alive & (rng.random(cap) < 0.9)

    dst_j, ok_j = jops.allocate_slots(jnp.asarray(~alive), jnp.asarray(want))
    dst, ok = tops.allocate_slots(torch.as_tensor(~alive),
                                  torch.as_tensor(want))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(dst_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert int(ok.sum()) < int(want.sum())  # more wants than free slots

    x = rng.standard_normal((cap, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tops.scatter_rows(torch.as_tensor(x), dst, torch.as_tensor(x[::-1]
                                                                   .copy())),
        np.asarray(jops.scatter_rows(jnp.asarray(x), dst_j,
                                     jnp.asarray(x[::-1].copy()))))

    a, b = tops.copy_to_slots(tp, tst, dst)
    c, d = jops.copy_to_slots(jp, jst, dst_j)
    _assert_state_equal(a, b, c, d)

    sel = torch.as_tensor(want)
    samples = jax.random.normal(jax.random.PRNGKey(3), (2, cap, 3))
    a, b = tops.split_to_slots(tp, tst, sel, dst,
                               torch.as_tensor(np.array(samples)))
    c, d = jops.split_to_slots(jp, jst, jnp.asarray(want), dst_j,
                               jax.random.PRNGKey(3))
    _assert_state_equal(a, b, c, d, approx=("means", "scales"))

    kill = torch.as_tensor(rng.random(cap) < 0.3)
    a, b = tops.remove_slots(tp, tst, kill)
    c, d = jops.remove_slots(jp, jst, jnp.asarray(kill.numpy()))
    _assert_state_equal(a, b, c, d)

    a, b = tops.reset_opacities(tp, tst, 0.01, torch.as_tensor(alive))
    c, d = jops.reset_opacities(jp, jst, 0.01, jnp.asarray(alive))
    _assert_state_equal(a, b, c, d)


def test_default_strategy_matches_jax(rng):
    cap, C, Wd, Hd = 96, 2, 64, 48
    p = _params(rng, cap)
    p["opacities"][rng.random(cap) < 0.3] = jsplats.DEAD_OPACITY_LOGIT
    p["opacities"][:4] = -6.0  # below prune_opa: pruned
    p["scales"][:cap // 2] = rng.normal(-6, 0.5, (cap // 2, 3))  # small
    p, jst, tst = _state_with_moments(rng, p)
    radii = rng.integers(0, 3, (C, cap)).astype(np.int32)
    v2d = (rng.standard_normal((C, cap, 2)) * 1e-3).astype(np.float32)
    info = dict(width=Wd, height=Hd, n_cameras=C)

    js, ts = JDefaultStrategy(), DefaultStrategy()
    jstate = js.initialize_state(cap, 1.7)
    tstate = ts.initialize_state(cap, 1.7)
    for _ in range(2):
        jstate = js.update_state(jstate, dict(info, radii=jnp.asarray(
            radii)), jnp.asarray(v2d))
        tstate = ts.update_state(tstate, dict(info, radii=torch.as_tensor(
            radii)), torch.as_tensor(v2d))
    for k in ("grad2d", "count"):
        assert close(tstate[k], jstate[k], 1e-6), k

    key = jax.random.PRNGKey(7)
    k_split = jax.random.split(key)[1]
    samples = torch.as_tensor(np.array(
        jax.random.normal(k_split, (2, cap, 3))))
    for step in (4000,):  # after reset_every: the too-big prune applies too
        c, d, jstate2 = js.refine({k: jnp.asarray(v) for k, v in p.items()},
                                  jst, jstate, step, key)
        a, b, tstate2 = ts.refine(_to_torch(p), tst, tstate, step,
                                  split_samples=samples)
        _assert_state_equal(a, b, c, d, approx=("means", "scales"))
        assert not any(bool(v.any()) for k, v in tstate2.items()
                       if k != "scene_scale")
    live = lambda o: int((np.asarray(o) > jsplats.DEAD_OPACITY_LOGIT + 1).sum())
    assert live(a["opacities"]) != live(p["opacities"])

    a, b = ts.maybe_reset_opacity(_to_torch(p), tst, 3000)
    c, d = js.maybe_reset_opacity({k: jnp.asarray(v) for k, v in p.items()},
                                  jst, 3000)
    _assert_state_equal(a, b, c, d)


def spy_jax_view_orders(monkeypatch):
    """Records each permutation that the JAX trainer module draws with
    numpy (its Runner.train's view order) into the returned list."""
    import gscodec_studio_tpu.training.trainer as jtrainer

    orders = []

    class Rng:
        def __init__(self, g):
            self.g = g

        def permutation(self, n):
            out = self.g.permutation(n)
            orders.append(out.tolist())
            return out

        def __getattr__(self, name):
            return getattr(self.g, name)

    class Random:
        def default_rng(self, *a, **kw):
            return Rng(np.random.default_rng(*a, **kw))

        def __getattr__(self, name):
            return getattr(np.random, name)

    class Numpy:
        random = Random()

        def __getattr__(self, name):
            return getattr(np, name)

    monkeypatch.setattr(jtrainer, "np", Numpy())
    return orders


def test_runner_step_matches_jax(fake_scene, tmp_path, monkeypatch):
    parser, trainset, valset = fake_scene
    jax_orders = spy_jax_view_orders(monkeypatch)
    # one tile per grid step: the same result, a faster interpret compile
    import gscodec_studio_tpu.ops.raster_v2 as jraster

    monkeypatch.setattr(jraster, "rasterize_to_pixels_v2", functools.partial(
        jraster.rasterize_to_pixels_v2, tiles_per_step=1))
    kw = dict(max_steps=1, capacity=256, isect_capacity=8192)
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
    # the same views in the same order as the JAX Runner, exactly
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


def test_port_training_improves_psnr(fake_scene, tmp_path):
    """The port's analog of test_training_improves_psnr: 40 steps on the
    CPU with two refines."""
    parser, trainset, valset = fake_scene
    cfg = Config(result_dir=str(tmp_path), max_steps=40, sh_degree=0,
                 sh_degree_interval=1, capacity=256, isect_capacity=8192,
                 refine_start_iter=10, refine_every=20)
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
    assert (tmp_path / "stats" / "after.json").exists()


def test_finite_gate_skips_a_poisoned_step(fake_scene, tmp_path):
    parser, trainset, valset = fake_scene
    runner = Runner(Config(result_dir=str(tmp_path), capacity=256,
                           isect_capacity=8192), parser=parser,
                    trainset=trainset, valset=valset, device="cpu")
    runner.splats["shN"][0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in runner.splats.items()}
    out = runner.train_step([0], sh_degree=1)
    assert out["skipped"] and runner.skipped_steps == 1
    for k in NAMES:
        assert torch.equal(runner.splats[k].nan_to_num(),
                           before[k].nan_to_num())
    assert runner.opt_states["means"]["count"] == 0


@pytest.mark.parametrize("field,value", [
    ("pose_opt", True), ("app_opt", True),
    ("use_bilateral_grid", True), ("depth_loss", True), ("mesh_devices", 2),
    ("mesh_devices", 4), ("init_type", "random"),
    ("eval_save_images", True), ("tb_histograms_every", 10),
])
def test_unported_options_raise(field, value, tmp_path):
    cfg = dataclasses.replace(Config(result_dir=str(tmp_path)),
                              **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Runner(cfg, parser=object(), device="cpu")


@pytest.mark.parametrize("field,value", [("attr_dtype", "bf16"),
                                         ("log_composite", True)])
def test_precision_options_pass_through(fake_scene, tmp_path, monkeypatch,
                                        field, value):
    """The sorted table's precision options, refused before they were
    ported, reach the training render's rasterizer as the JAX Runner passes
    them (gscodec_studio_tpu/training/trainer.py:476,485)."""
    import gscodec_studio_tpu_torch.training.trainer as ttrainer

    parser, trainset, valset = fake_scene
    seen = []

    def spy(*args, **kw):
        seen.append({k: kw.get(k) for k in ("attr_dtype", "log_composite")})
        return rasterization(*args, **kw)

    monkeypatch.setattr(ttrainer, "rasterization", spy)
    cfg = dataclasses.replace(
        Config(result_dir=str(tmp_path), max_steps=1, capacity=256,
               isect_capacity=8192), **{field: value})
    runner = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                    device="cpu")
    losses = runner.train(log_every=0)
    assert np.isfinite(losses).all() and runner.skipped_steps == 0
    assert seen and seen[0][field] == value
    other = "log_composite" if field == "attr_dtype" else "attr_dtype"
    assert seen[0][other] == getattr(Config(), other)


def test_unhonoured_defaults_are_named(fake_scene, tmp_path, capsys):
    parser, trainset, valset = fake_scene
    Runner(Config(result_dir=str(tmp_path), capacity=256), parser=parser,
           trainset=trainset, valset=valset, device="cpu")
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if "ignored" in ln]
    for name in ("tb_every", "skip_probe"):
        assert name in line
    assert "save_steps" not in line  # checkpoints are written
    Runner(Config(result_dir=str(tmp_path), capacity=256, save_steps=(),
                  tb_every=0, skip_probe=False), parser=parser,
           trainset=trainset, valset=valset, device="cpu")
    assert "ignored" not in capsys.readouterr().out


def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert tf == jf


def test_checkpoint_stand_in(tmp_path):
    parser, trainset, valset = checkpoint_stand_in(
        CHECKPOINT, n_views=3, width=80, height=52, device="cpu")
    assert (len(trainset), len(valset)) == (2, 1)
    with np.load(CHECKPOINT) as z:
        live = jax.nn.sigmoid(z["opacities"].reshape(-1)) > 0.005
        means, sh0 = z["means"][live], z["sh0"].reshape(-1, 3)[live]
    assert 0 < len(means) < len(live)  # dead and pruned slots are no points
    np.testing.assert_array_equal(parser.points, means)
    rgb = np.clip(np.asarray(jsplats.sh_to_rgb(jnp.asarray(sh0))), 0, 1)
    np.testing.assert_allclose(parser.points_rgb / 255.0, rgb, atol=1e-6)
    locs = parser.camtoworlds[:, :3, 3]
    want = 1.1 * np.linalg.norm(locs - locs.mean(0), axis=1).max()
    assert parser.scene_scale == pytest.approx(want)
    img = valset[0]["image"]
    assert img.shape == (52, 80, 3) and float(img.mean()) > 0.05
