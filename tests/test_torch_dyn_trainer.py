"""gscodec_studio_tpu_torch's DynRunner against the JAX package's on the
CPU, on a synthetic moving scene of tests/test_dyn.py's size (4 views x 4
frames at 48x32, 80 Gaussians; its targets rendered by the JAX package's
dense oracle; the JAX runner's eval() taken under one jit of its render),
both runners on rasterizer="reference" (plain jnp on the JAX side, no
interpret-mode Pallas; the port's dense oracle). Three legs:
the STG recipe (the Sandwich decoder, the STG compression simulation with
its entropy gates opened, ModifiedSTG), STG with the omega freeze moved to
step 5 (the linear colour head), and MCMC (the rgb head), each 10 steps
with refines at steps 5 and 10 (MCMC: at 5). Both start from the same
splats (create_dyn_splats draws the JAX package's numbers), decoder and
sim parameters (carried across); every random draw of the JAX runner (the
splits' normals, MCMC's noise and relocation sources) is handed to the
port through spies. Then the port alone: export_frames,
render_view_video, the INVR and STG readers against the JAX package's on
written directories, and dyn_trainer_cli.main on an INVR directory.

Tolerances:
  * each step's loss within 1e-5 relative of JAX's;
  * after the 10 steps every splat leaf, the decoder and the sim
    parameters within 1e-4 of the leaf's largest |value| (float32 in
    another order: where a gradient is small, Adam's normalized step turns
    its rounding into a move of a fraction of the rate, 5e-2 for the
    opacities; measured at most 8.5e-5 on opacities of |2.6|, 3.3e-5 of
    their scale), the strategy state's counters equal, eval()'s PSNR
    within 1e-4 relative and SSIM within 1e-5 absolute;
  * the readers: the same arrays bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.datasets.invr import INVRDataset as JINVRDataset
from gscodec_studio_tpu.datasets.invr import INVRParser as JINVRParser
from gscodec_studio_tpu.datasets.stg_readers import STGDataset as JSTGDataset
from gscodec_studio_tpu.datasets.stg_readers import STGParser as JSTGParser
from gscodec_studio_tpu.models import temporal as jt
from gscodec_studio_tpu.models.splats import create_splats as jcreate_splats
from gscodec_studio_tpu.models.splats import (
    splat_activations as jsplat_activations)
from gscodec_studio_tpu.rendering import rasterization as jrasterization
from gscodec_studio_tpu.strategy import ops as jops
from gscodec_studio_tpu.training.dyn_trainer import DynConfig as JDynConfig
from gscodec_studio_tpu.training.dyn_trainer import DynRunner as JDynRunner
from gscodec_studio_tpu_torch import dyn_trainer_cli
from gscodec_studio_tpu_torch.compression.png_io import read_png, write_png
from gscodec_studio_tpu_torch.datasets.invr import INVRDataset, INVRParser
from gscodec_studio_tpu_torch.datasets.stg_readers import (STGDataset,
                                                           STGParser)
from gscodec_studio_tpu_torch.models.splats import (from_jax_decoder,
                                                    from_jax_sim_params)
from gscodec_studio_tpu_torch.training.dyn_trainer import (DynConfig,
                                                           DynRunner)

from tests.test_torch_colmap import write_colmap_dir
from tests.test_torch_train import one_torch_thread  # noqa: F401
from tests.test_torch_train_ladder import (hand_over_draws,
                                           spy_jax_mcmc_draws)

W, H, N_GT = 48, 32, 80
BASE = dict(max_steps=10, capacity=160, mcmc_cap_max=128,
            isect_capacity=8192, steps_per_dispatch=5, refine_start_iter=2,
            refine_every=5, rasterizer="reference")
LEGS = {
    "sandwich_sim_modified_stg": dict(
        strategy="modified_stg", color_mode="sandwich", compression_sim=True,
        entropy_model_opt=True, rd_lambda=1e-3),
    "stg_freeze": dict(strategy="stg", color_mode="linear"),
    "mcmc": dict(strategy="mcmc", color_mode="rgb", refine_stop_iter=8),
}
FREEZE_AT = 5  # the stg leg's freeze_start_iter
ENTROPY_AT = 3  # the sandwich leg's entropy gates


@pytest.fixture(scope="module")
def video():
    """tests/test_dyn.py's moving-blob video, rendered by the JAX dense
    oracle: (samples, init points, init colours)."""
    rng = np.random.default_rng(42)
    pts = (rng.random((N_GT, 3), dtype=np.float32) - 0.5) * 2
    gt = jcreate_splats(pts, rng.random((N_GT, 3)).astype(np.float32),
                        cap=N_GT, sh_degree=0, init_opacity=0.8,
                        init_scale=2.5)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    vel = np.array([0.4, 0.0, 0.0], np.float32)
    render = jax.jit(lambda vm, means: jrasterization(
        means, *jsplat_activations(gt)[1:],
        jnp.concatenate([gt["sh0"], gt["shN"]], axis=1), vm[None],
        jnp.asarray(K)[None], W, H, sh_degree=0, isect_capacity=8192,
        rasterizer="reference")[0])
    samples = []
    for vi in range(4):
        ang = 0.2 * (vi / 4 - 0.5)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                                [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, -4.0], np.float32)
        for fi in range(4):
            t = fi / 3
            img = render(jnp.asarray(np.linalg.inv(c2w)),
                         gt["means"] + jnp.asarray(vel) * t)
            samples.append({"camtoworld": c2w, "K": K, "timestamp": t,
                            "image": np.clip(np.asarray(img[0]), 0, 1)})
    points = np.asarray(gt["means"]) + 0.05 * rng.standard_normal(
        (N_GT, 3)).astype(np.float32)
    return samples, points, rng.random((N_GT, 3)).astype(np.float32)


def jax_eval(jr):
    """The JAX runner's eval() under one jit of its render (its own eval
    renders op by op, 10-20 s here): mean PSNR and SSIM of the clipped
    renders over the validation samples."""
    from gscodec_studio_tpu.training.losses import psnr, ssim

    cap = jr.cfg.isect_capacity or 1 << 19
    render = jax.jit(lambda sp, dec, c2w, K, t: jnp.clip(jr._render(
        sp, c2w, K, t, W, H, cap, dec)[0][0], 0, 1))
    out = {"psnr": [], "ssim": []}
    for d in jr.valset:
        img = render(jr.splats, jr.decoder_params,
                     jnp.asarray(d["camtoworld"]), jnp.asarray(d["K"]),
                     jnp.asarray(d["timestamp"], jnp.float32))
        tgt = jnp.asarray(d["image"])
        out["psnr"].append(float(psnr(img, tgt)))
        out["ssim"].append(float(ssim(img[None], tgt[None])))
    return {k: float(np.mean(v)) for k, v in out.items()}


def spy_jax_split_draws(monkeypatch):
    """Records the split normals of each JAX default-strategy refine."""
    draws = []
    split_fn = jops.split_to_slots

    def split_spy(params, opt_states, sel, dst, key, *a, **kw):
        jax.debug.callback(lambda x: draws.append(np.array(x)),
                           jax.random.normal(key, (2, sel.shape[0], 3)))
        return split_fn(params, opt_states, sel, dst, key, *a, **kw)

    monkeypatch.setattr(jops, "split_to_slots", split_spy)
    return draws


def _prepare(runner, leg, jax_side):
    # anisotropic scales: the k-NN ones are isotropic, which makes the true
    # quaternion gradient zero and its computed value rounding noise that
    # Adam turns into steps of lr * sign(noise)
    noise = np.random.default_rng(1).normal(
        0, 0.3, tuple(runner.splats["scales"].shape)).astype(np.float32)
    runner.splats["scales"] = runner.splats["scales"] + (
        jnp.asarray(noise) if jax_side else torch.as_tensor(noise))
    if leg == "sandwich_sim_modified_stg":
        sim = runner.compression_sim
        sim.entropy_steps = {k: ENTROPY_AT for k in sim.entropy_steps}
    if leg == "stg_freeze":
        if jax_side:
            object.__setattr__(runner.strategy, "freeze_start_iter",
                               FREEZE_AT)
        else:
            import dataclasses

            runner.strategy = dataclasses.replace(
                runner.strategy, freeze_start_iter=FREEZE_AT)


@pytest.fixture(scope="module", params=list(LEGS))
def legs(request, video, tmp_path_factory):
    leg = request.param
    samples, points, rgbs = video
    ds, val = samples, samples[1::6]
    kw = dict(BASE, **LEGS[leg])
    mp = pytest.MonkeyPatch()
    try:
        mcmc = spy_jax_mcmc_draws(mp) if leg == "mcmc" else None
        splits = spy_jax_split_draws(mp) if leg != "mcmc" else None
        jr = JDynRunner(JDynConfig(result_dir=str(tmp_path_factory.mktemp(
            "j")), **kw), points, rgbs, ds, val, scene_scale=1.0)
        _prepare(jr, leg, True)
        init = {k: np.array(v) for k, v in jr.splats.items()}
        jlosses = jr.train(log_every=0)
        jeval = jax_eval(jr)
        tr = DynRunner(DynConfig(result_dir=str(tmp_path_factory.mktemp(
            "t")), **kw), points, rgbs, ds, val, scene_scale=1.0,
            device="cpu")
        _prepare(tr, leg, False)
        for k, v in tr.splats.items():  # the same draws
            np.testing.assert_array_equal(v.numpy(), init[k], err_msg=k)
        assert tr.order == np.random.default_rng(42).permutation(
            len(ds)).tolist()
        if jr.decoder_params is not None:
            tr.decoder_params, _ = from_jax_decoder(jr_init_decoder(jr),
                                                    device="cpu")
        if jr.compression_sim is not None:
            tr.sim_params = from_jax_sim_params(
                jax.tree_util.tree_map(np.asarray, jr_init_sim(jr)),
                device="cpu")
        if mcmc is not None:
            hand_over_draws(mp, tr, mcmc)
        else:
            it = iter(splits)
            mp.setattr(tr, "_split_samples",
                       lambda cap: torch.as_tensor(next(it)))
        tlosses = tr.train(log_every=0)
        teval = tr.eval()
    finally:
        mp.undo()
    return dict(leg=leg, jr=jr, tr=tr, jlosses=jlosses, tlosses=tlosses,
                jeval=jeval, teval=teval, mcmc=mcmc, splits=splits)


_INIT = {}


def jr_init_decoder(jr):
    return _INIT[id(jr)]["decoder"]


def jr_init_sim(jr):
    return _INIT[id(jr)]["sim"]


@pytest.fixture(autouse=True, scope="module")
def record_jax_inits():
    """Keeps each JAX runner's initial decoder and sim parameters: its
    train replaces them."""
    init = JDynRunner.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        _INIT[id(self)] = dict(
            decoder=None if self.decoder_params is None else
            jax.tree_util.tree_map(np.array, self.decoder_params),
            sim=None if self.compression_sim is None else
            jax.tree_util.tree_map(np.array, self.sim_params))

    mp = pytest.MonkeyPatch()
    mp.setattr(JDynRunner, "__init__", spy)
    yield
    mp.undo()


def _close(a, b, what):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=max(
        1e-4 * float(np.abs(b).max()), 5e-5), err_msg=what)


def test_dyn_runner_matches_jax(legs):
    jr, tr, leg = legs["jr"], legs["tr"], legs["leg"]
    assert len(legs["tlosses"]) == len(legs["jlosses"]) == 10
    np.testing.assert_allclose(legs["tlosses"], legs["jlosses"], rtol=1e-5)
    for k, v in tr.splats.items():
        _close(v, jr.splats[k], k)
    if jr.decoder_params is not None:
        got, _ = from_jax_decoder(jr.decoder_params, device="cpu")
        for k, v in tr.decoder_params.items():
            _close(v, got[k], k)
            assert not torch.equal(v, from_jax_decoder(
                jr_init_decoder(jr), device="cpu")[0][k])
    if jr.compression_sim is not None:
        want = from_jax_sim_params(jax.tree_util.tree_map(
            np.asarray, jr.sim_params), device="cpu")
        assert sorted(tr.sim_params) == sorted(want)
        for k, v in tr.sim_params.items():
            _close(v, want[k], k)
    for k in ("densify_count", "omega_keep", "allocated"):
        if k in jr.strategy_state:
            np.testing.assert_array_equal(
                tr.strategy_state[k].numpy(),
                np.asarray(jr.strategy_state[k]), err_msg=k)
    np.testing.assert_allclose(legs["teval"]["psnr"], legs["jeval"]["psnr"],
                               rtol=1e-4)
    np.testing.assert_allclose(legs["teval"]["ssim"], legs["jeval"]["ssim"],
                               atol=1e-5)
    assert [e["step"] for e in tr.events] == (
        [5] if leg == "mcmc" else [5, 10])
    if leg == "mcmc":  # every JAX draw handed over: 10 noises, 1 refine
        assert len(legs["mcmc"]["noise"]) == 10
        assert len(legs["mcmc"]["sampled"]) == 1
    else:
        assert len(legs["splits"]) == 2
    if leg == "stg_freeze":  # frozen omegas are zero after the refines
        keep = tr.strategy_state["omega_keep"]
        assert not keep.all()
        assert not tr.splats["omega"][~keep].any()


def test_dyn_exports_and_video(legs, tmp_path):
    tr = legs["tr"]
    ts = [0.0, 0.5, 1.0]
    frames = tr.export_frames(ts)
    jsplats = {k: jnp.asarray(v.numpy()) for k, v in tr.splats.items()}
    for t, fr in zip(ts, frames):
        ref = jt.extract_frame(jsplats, t)
        assert sorted(fr) == sorted(ref)
        assert len(fr["means"]) == len(ref["means"]) > 0
        np.testing.assert_allclose(fr["means"], ref["means"], atol=1e-6)
    d = tr.valset[0]
    out = tr.render_view_video(d["camtoworld"], d["K"], 40, 32, ts,
                               str(tmp_path / "v.mp4"))
    files = sorted(os.listdir(out)) if os.path.isdir(out) else [out]
    if os.path.isdir(out):  # no mp4 writer: PNG frames
        assert files == ["0000.png", "0001.png", "0002.png"]
        assert read_png(os.path.join(out, files[0])).shape == (32, 40, 3)


def test_dyn_runner_defaults_to_cuda(video, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    samples, points, rgbs = video
    with pytest.raises(RuntimeError, match="CUDA"):
        DynRunner(DynConfig(result_dir=str(tmp_path)), points, rgbs,
                  samples, samples)
    with pytest.raises(ValueError, match="color_mode"):
        DynRunner(DynConfig(result_dir=str(tmp_path), color_mode="mlp"),
                  points, rgbs, samples, samples, device="cpu")


def write_invr_dir(root, samples, split_of=lambda i: "train", alpha=False):
    """An INVR directory of ``samples``: transforms_<split>.json (Blender
    axes, fl_x) and PNG frames."""
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    metas = {}
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for i, s in enumerate(samples):
        img = (np.clip(s["image"], 0, 1) * 255).astype(np.uint8)
        if alpha:
            a = np.full(img.shape[:2] + (1,), 200, np.uint8)
            a[: img.shape[0] // 2] = 255
            img = np.concatenate([img, a], -1)
        write_png(os.path.join(root, "frames", f"{i:04d}.png"), img)
        split = split_of(i)
        metas.setdefault(split, {"fl_x": float(s["K"][0, 0]),
                                 "fl_y": float(s["K"][1, 1]), "frames": []})
        metas[split]["frames"].append({
            "file_path": f"frames/{i:04d}",
            "transform_matrix": (np.asarray(s["camtoworld"], np.float64)
                                 @ flip).tolist(),
            "time": float(s["timestamp"])})
    for split, meta in metas.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return root


@pytest.mark.parametrize("factor,alpha", [(1, False), (2, True)])
def test_invr_reader_matches_jax(video, tmp_path, factor, alpha):
    samples = video[0]
    root = write_invr_dir(str(tmp_path), samples[:6], alpha=alpha)
    np.save(os.path.join(root, "points3d.npy"), video[1])
    tp, jp = INVRParser(root, factor=factor), JINVRParser(root,
                                                          factor=factor)
    np.testing.assert_array_equal(tp.K, jp.K)
    np.testing.assert_array_equal(tp.points, jp.points)
    assert (tp.width, tp.height) == (jp.width, jp.height)
    td, jd = INVRDataset(tp), JINVRDataset(jp)
    assert len(td) == len(jd) == 6
    for i in range(6):
        a, b = td[i], jd[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("kind", ["n3d", "technicolor"])
def test_stg_reader_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(3)
    root = str(tmp_path)
    write_colmap_dir(os.path.join(root, "colmap_0"), rng, width=24,
                     height=16, models=("PINHOLE",), n_images=3)
    names = sorted(os.listdir(os.path.join(root, "colmap_0", "images")))
    for t in range(1, 3):
        d = os.path.join(root, f"colmap_{t}", "images")
        os.makedirs(d)
        for n in names:
            write_png(os.path.join(d, n), rng.integers(
                0, 256, (16, 24, 3)).astype(np.uint8))
    if kind == "n3d":
        pb = np.zeros((3, 17))
        pb[:, :15] = np.tile(np.c_[np.eye(3, 4), [16, 24, 20.0]].ravel(),
                             (3, 1))
        pb[:, 15:] = [0.5, 6.0]
        np.save(os.path.join(root, "poses_bounds.npy"), pb)
    for split in ("train", "test"):
        kw = dict(dataset_type=kind, duration=3, split=split, llffhold=2)
        tp, jp = STGParser(root, **kw), JSTGParser(root, **kw)
        np.testing.assert_array_equal(tp.points, jp.points)
        assert tp.scene_scale == jp.scene_scale
        assert (tp.near, tp.far) == (jp.near, jp.far)
        assert len(tp.views) == len(jp.views) > 0
        td, jd = STGDataset(tp), JSTGDataset(jp)
        for i in range(len(td)):
            a, b = td[i], jd[i]
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


def test_dyn_trainer_cli_on_invr(video, tmp_path):
    samples = video[0]
    root = write_invr_dir(str(tmp_path / "scene"), samples,
                          split_of=lambda i: "val" if i % 4 == 0
                          else "train")
    out = tmp_path / "run"
    runner = dyn_trainer_cli.main([
        "--data-dir", root, "--result-dir", str(out), "--factor", "1",
        "--max-steps", "6", "--cap-max", "200", "--init-points", "120",
        "--strategy", "mcmc", "--color-mode", "sandwich",
        "--rasterizer", "reference", "--export-frames", "3",
        "--eval-video", "--eval-video-frames", "2", "--isect-capacity",
        "8192", "--device", "cpu"])
    stats = json.loads((out / "stats.json").read_text())
    assert sorted(stats) == ["final_loss", "psnr", "secs", "ssim", "steps"]
    assert stats["steps"] == 6 and np.isfinite(stats["psnr"])
    assert sorted(os.listdir(out / "ply_seq")) == [
        f"frame_{i:04d}.ply" for i in range(3)]
    assert (out / "eval_view0").is_dir() or (out / "eval_view0.mp4").exists()
    assert len(runner.trainset) == 12 and len(runner.valset) == 4
    assert runner.splats["means"].shape[0] == 200
