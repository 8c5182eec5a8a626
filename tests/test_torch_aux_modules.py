"""gscodec_studio_tpu_torch's per-image modules, their optimizers and the
command line against the JAX package on the CPU: the 6D rotation, the pose
deltas, appearance (with the SH warm-up's zero padding), the bilateral
grid's slice and TV loss and the depth loss's bilinear sampler, forward
and gradients for a seeded cotangent; the modules' AdamW and Adam against
optax over three updates; parse_config's types.

Tolerances: forward values and gradients within rtol 1e-5 of the JAX
package's (atol 1e-6 of each output's largest |value|: float32 in another
order); the optimizers within 1e-6 of each parameter's largest |value|
(optax's arithmetic, step for step).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gscodec_studio_tpu.training import trainer as jtrainer
from gscodec_studio_tpu.utils import bilagrid as jbilagrid
from gscodec_studio_tpu.utils import camera_opt as jcam
from gscodec_studio_tpu.utils.cli import parse_config as jparse_config
from gscodec_studio_tpu_torch.optimizers.builders import (AdamGroup,
                                                          adam_state,
                                                          apply_updates)
from gscodec_studio_tpu_torch.training import trainer as ttrainer
from gscodec_studio_tpu_torch.utils import bilagrid as tbilagrid
from gscodec_studio_tpu_torch.utils import camera_opt as tcam
from gscodec_studio_tpu_torch.utils.cli import parse_config

from tests.test_torch_train import one_torch_thread  # noqa: F401


def check_vjp(jf, tf, inputs, rng, rtol=1e-5):
    """jf (JAX) and tf (torch) on the same numpy inputs: outputs, and the
    gradients of <output, seeded cotangent> with respect to every input."""
    jout, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(x) for x in inputs])
    ct = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tf(*ts)
    tgrads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        ts, torch.autograd.grad(tout, ts, torch.as_tensor(ct),
                                allow_unused=True))]
    for a, b in [(tout, jout)] + list(zip(tgrads, jgrads)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=rtol,
            atol=1e-6 * max(float(np.abs(b).max()), 1e-30))
    return tout


def test_rotation_6d_matches_jax(rng):
    d6 = rng.standard_normal((7, 6)).astype(np.float32)
    R = check_vjp(jcam.rotation_6d_to_matrix, tcam.rotation_6d_to_matrix,
                  [d6], rng)
    eye = R @ R.transpose(-1, -2)
    assert torch.allclose(eye, torch.eye(3).expand(7, 3, 3), atol=1e-5)


def test_camera_opt_apply_matches_jax(rng):
    n = 5
    params = (np.asarray(jcam.camera_opt_init(n))
              + 0.1 * rng.standard_normal((n, 9))).astype(np.float32)
    np.testing.assert_array_equal(tcam.camera_opt_init(n).numpy(),
                                  np.asarray(jcam.camera_opt_init(n)))
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, :3, :] += 0.3 * rng.standard_normal((3, 3, 4)).astype(np.float32)
    ids = np.array([4, 0, 2])
    check_vjp(lambda p, c: jcam.camera_opt_apply(p, c, jnp.asarray(ids)),
              lambda p, c: tcam.camera_opt_apply(p, c, torch.as_tensor(ids)),
              [params, c2w], rng)
    # identity deltas leave the cameras as they are
    np.testing.assert_allclose(tcam.camera_opt_apply(
        tcam.camera_opt_init(n), torch.as_tensor(c2w),
        torch.as_tensor(ids)).numpy(), c2w, atol=1e-6)


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_appearance_matches_jax(rng, sh_degree):
    """Per-(camera, Gaussian) colours through the same weights; below the
    maximum SH degree the unused bases are zero-padded."""
    app = jcam.appearance_opt_init(jax.random.PRNGKey(0), 4, feature_dim=8,
                                   embed_dim=5, sh_degree=3)
    embeds = rng.standard_normal((4, 5)).astype(np.float32)
    ws = [np.asarray(layer["w"]) for layer in app["mlp"]]
    bs = [0.1 * rng.standard_normal(w.shape[1]).astype(np.float32)
          for w in ws]
    feats = rng.random((30, 8)).astype(np.float32)
    dirs = rng.standard_normal((2, 30, 3)).astype(np.float32)
    ids = np.array([3, 1])

    def jf(e, w0, b0, w1, b1, f, d):
        return jcam.appearance_opt_apply(
            {"embeds": e, "mlp": [{"w": w0, "b": b0}, {"w": w1, "b": b1}]},
            f, jnp.asarray(ids), d, sh_degree, sh_degree_max=3)

    def tf(e, w0, b0, w1, b1, f, d):
        return tcam.appearance_opt_apply(
            e, [{"w": w0, "b": b0}, {"w": w1, "b": b1}], f,
            torch.as_tensor(ids), d, sh_degree, sh_degree_max=3)

    out = check_vjp(jf, tf, [embeds, ws[0], bs[0], ws[1], bs[1], feats, dirs],
                    rng)
    assert out.shape == (2, 30, 3)
    module = tcam.AppearanceOptModule(4, feature_dim=8, embed_dim=5,
                                      sh_degree=3)
    assert dict((k, tuple(v.shape)) for k, v in module.named_parameters()) \
        == {"embeds": (4, 5), "mlp.0.w": (5 + 8 + 16, 64), "mlp.0.b": (64,),
            "mlp.1.w": (64, 3), "mlp.1.b": (3,)}
    assert module(torch.as_tensor(feats), torch.as_tensor(ids),
                  torch.as_tensor(dirs), sh_degree).shape == (2, 30, 3)


def test_bilagrid_matches_jax(rng):
    n, D, H, W = 3, 4, 5, 6
    grids = (np.asarray(jbilagrid.bilagrid_init(n, D, H, W))
             + 0.1 * rng.standard_normal((n, D, H, W, 12))).astype(np.float32)
    np.testing.assert_array_equal(tbilagrid.bilagrid_init(n, D, H, W).numpy(),
                                  np.asarray(jbilagrid.bilagrid_init(n, D, H,
                                                                     W)))
    rgb = rng.random((2, 9, 13, 3)).astype(np.float32)
    rgb[0, :2] = 0.0  # at the lower bound of the luma's clip
    ids = np.array([2, 0])
    check_vjp(lambda g, x: jax.vmap(jbilagrid.bilagrid_slice,
                                    in_axes=(None, 0, 0))(
                  g, jnp.asarray(ids), x),
              lambda g, x: tbilagrid.bilagrid_slice(g, torch.as_tensor(ids),
                                                    x),
              [grids, rgb], rng)
    jtv, jg = jax.jit(jax.value_and_grad(jbilagrid.bilagrid_tv_loss))(
        jnp.asarray(grids))
    g = torch.tensor(grids, requires_grad=True)
    tv = tbilagrid.bilagrid_tv_loss(g)
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jtv), rel=1e-5)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)
    # identity grids leave the colours as they are
    np.testing.assert_allclose(tbilagrid.bilagrid_slice(
        tbilagrid.bilagrid_init(n, D, H, W), torch.as_tensor(ids),
        torch.as_tensor(rgb)).numpy(), rgb, atol=1e-6)


def test_sample_bilinear_matches_jax(rng):
    img = rng.random((2, 8, 10, 1)).astype(np.float32)
    pts = np.stack([rng.uniform(-1, 10, (2, 12)), rng.uniform(-1, 8, (2, 12))],
                   -1).astype(np.float32)
    pts[0, 0] = (9.0, 7.0)  # on the last pixel: the clipped corner
    check_vjp(lambda im: jtrainer._sample_bilinear(im, jnp.asarray(pts)),
              lambda im: ttrainer._sample_bilinear(im, torch.as_tensor(pts)),
              [img], rng)


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_aux_optimizers_match_optax(rng, kind):
    """The modules' groups (the Runner's _init_aux) against optax.adamw
    (lr, weight_decay, eps=1e-15) and optax.adam(2e-3, eps=1e-15)."""
    p0 = rng.standard_normal((6, 9)).astype(np.float32)
    if kind == "adamw":
        tx = optax.adamw(1e-3 * np.sqrt(2.0), weight_decay=1e-2, eps=1e-15)
        group = AdamGroup(1e-3 * np.sqrt(2.0), 0.9, 0.999, 1e-15,
                          weight_decay=1e-2)
    else:
        tx = optax.adam(2e-3, eps=1e-15)
        group = AdamGroup(2e-3, 0.9, 0.999, 1e-15)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = {"x": torch.as_tensor(p0)}
    tst = {"x": adam_state(tp["x"])}
    for _ in range(3):
        g = (rng.standard_normal(p0.shape)
             * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tst = apply_updates({"x": group}, tst, tp,
                                {"x": torch.as_tensor(g)})
    scale = float(np.abs(np.asarray(jp)).max())
    assert float(np.abs(tp["x"].numpy() - np.asarray(jp)).max()) \
        <= 1e-6 * scale
    assert tst["x"]["count"] == 3


ARGV = ["--max-steps", "30", "--capacity", "100", "--rd-lambda", "0.5",
        "--eval-steps", "5", "--pose-opt", "--refine-every", "none"]


def test_cli_types_values_unlike_jax():
    """parse_config resolves the annotations: ints, floats, Optionals and
    tuples come back typed. The JAX package's parser reads
    dataclasses.Field.type, a string under its trainer's
    ``from __future__ import annotations``, and leaves them strings (the
    ROADMAP watch-list)."""
    from gscodec_studio_tpu.training.trainer import Config as JConfig
    from gscodec_studio_tpu_torch.simple_trainer import PRESETS

    cfg = parse_config(ttrainer.Config, PRESETS, ["mcmc"] + ARGV)
    assert (cfg.max_steps, cfg.capacity, cfg.rd_lambda) == (30, 100, 0.5)
    assert type(cfg.max_steps) is int and type(cfg.rd_lambda) is float
    assert cfg.eval_steps == (5,) and cfg.pose_opt is True
    assert cfg.refine_every is None and cfg.strategy == "mcmc"
    assert cfg.init_opa == 0.5  # the preset's
    cfg = parse_config(ttrainer.Config, PRESETS,
                       ["--eval-steps", "5", "10", "--bilagrid-shape", "4",
                        "8", "8", "--pose-opt", "false"])
    assert cfg.eval_steps == (5, 10) and cfg.bilagrid_shape == (4, 8, 8)
    assert cfg.pose_opt is False
    assert dataclasses.replace(cfg) == cfg

    jcfg = jparse_config(JConfig, None,
                         ["--max-steps", "30", "--capacity", "100",
                          "--rd-lambda", "0.5", "--eval-steps", "5"])
    assert (jcfg.max_steps, jcfg.capacity, jcfg.rd_lambda,
            jcfg.eval_steps) == ("30", "100", "0.5", "5")
    with pytest.raises(SystemExit):
        jparse_config(JConfig, None, ["--eval-steps", "5", "10"])
