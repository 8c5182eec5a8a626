"""gscodec_studio_tpu_torch's Runner with the per-image modules against the
JAX package's Runner on the CPU: both built with no parser from a COLMAP
directory written here (tests/test_torch_colmap.py's writer), with pose
deltas, appearance, the bilateral grid and the depth loss at batch size 2,
on rasterizer="reference" (plain jnp on the JAX side, no interpret-mode
Pallas). The port starts from the JAX Runner's initial splats and module
parameters (the draws of its quaternions, features and MLP weights).
Neither logger writes TensorBoard events here: torch.utils.tensorboard is
hidden while the runners are built and run (its import costs seconds and
its events are not compared); scalars.jsonl is.

Tolerances:
  * the two steps: each loss within 1e-5 relative of JAX's; every splat
    group and module parameter within 1e-5 relative or 1e-6 absolute
    (float32 in another order; Adam's first steps move a parameter by
    about lr * sign(gradient), so only real gradients are compared: the
    scales start anisotropic, as in test_torch_train.py), but the
    bilateral grid: fewer than 1% of its cells off that tolerance, and none
    by more than Adam's two steps, 2 * lr each (a cell beside a pixel whose
    luma lies on a cell boundary, to rounding, gets a weight of 0 in one
    package and of a few ulp in the other);
  * init_type="random": the drawn points, scales and colours bit for bit;
  * checkpoints' aux/<i> leaves across, in both directions: bit for bit;
  * skips.jsonl after a poisoned pose row: global_step and bad_leaves
    equal, the loss within the step tolerance;
  * scalars.jsonl: the same rows (steps, keys, histogram tags), the
    values within the step tolerance;
  * render_traj: the same files, each frame within one 8-bit level.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.compression.png_io import read_png
from gscodec_studio_tpu_torch.models.splats import from_jax_sim_params
from gscodec_studio_tpu_torch.training.trainer import (PROBE_VERDICTS,
                                                       Config, Runner)
from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                            Runner2DGS)

from tests.test_torch_colmap import write_colmap_dir
from tests.test_torch_train import one_torch_thread  # noqa: F401

AUX = dict(data_factor=1, test_every=3, max_steps=2, batch_size=2,
           sh_degree=1, sh_degree_interval=1000, capacity=120,
           isect_capacity=8192, pose_opt=True, app_opt=True,
           app_embed_dim=4, app_feature_dim=8, use_bilateral_grid=True,
           bilagrid_shape=(4, 4, 4), depth_loss=True, depth_points_cap=16,
           rasterizer="reference", steps_per_dispatch=1, tb_every=1,
           tb_histograms_every=1, eval_steps=(), save_steps=())
POISONED_ROW = 2  # a pose row that the first step's batch uses


def close(a, b, rtol=1e-5, atol=1e-6, what=""):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_aux_numpy(aux):
    return jax.tree_util.tree_map(np.array, aux)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Runners after two steps from the same state, their scalars and
    trajectories, and the COLMAP directory."""
    root = write_colmap_dir(str(tmp_path_factory.mktemp("scene")),
                            np.random.default_rng(5), width=48, height=32,
                            models=("PINHOLE", "SIMPLE_PINHOLE"), n_images=6)
    out_j = str(tmp_path_factory.mktemp("jax"))
    out_t = str(tmp_path_factory.mktemp("port"))
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        jr = JRunner(JConfig(data_dir=root, result_dir=out_j,
                             skip_probe=False, **AUX))
        jr.splats["scales"] = jr.splats["scales"] + jnp.asarray(
            np.random.default_rng(1).normal(0, 0.3, (120, 3)).astype(
                np.float32))
        init = {k: np.array(v) for k, v in jr.splats.items()}
        init_aux = jax_aux_numpy(jr.aux_params)
        jlosses = jr.train(log_every=0)

        tr = Runner(Config(data_dir=root, result_dir=out_t, **AUX),
                    device="cpu")
        tr.splats = from_jax_sim_params(init, device="cpu")
        tr.aux_params = from_jax_sim_params(init_aux, device="cpu")
        assert tr.view_order == np.random.default_rng(42).permutation(
            len(tr.trainset)).tolist()
        tlosses = tr.train(log_every=0)
        scalars = {}
        for name, path in (("jax", out_j), ("port", out_t)):
            with open(os.path.join(path, "tb", "scalars.jsonl")) as f:
                scalars[name] = [json.loads(line) for line in f]
        traj = {"jax": jr.render_traj(0, "interp", n_frames=5),
                "port": tr.render_traj(0, "interp", n_frames=5)}
    finally:
        mp.undo()
    return dict(root=root, jr=jr, tr=tr, init=init, init_aux=init_aux,
                jlosses=jlosses, tlosses=tlosses, scalars=scalars,
                traj=traj)


def test_two_aux_steps_match_jax(runs):
    jr, tr = runs["jr"], runs["tr"]
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-5)
    assert tr.skipped_steps == 0
    assert sorted(tr.splats) == sorted(jr.splats) == [
        "colors", "features", "means", "opacities", "quats", "scales"]
    for k, v in tr.splats.items():
        close(v, jr.splats[k], what=k)
    got = tr.aux_params
    want = from_jax_sim_params(jax_aux_numpy(jr.aux_params), device="cpu")
    assert sorted(got) == sorted(want) == [
        "app_embeds", "app_mlp.0.b", "app_mlp.0.w", "app_mlp.1.b",
        "app_mlp.1.w", "bilagrid", "pose"]
    init = from_jax_sim_params(runs["init_aux"], device="cpu")
    for k, v in got.items():
        if k == "bilagrid":
            # a grid cell next to a pixel whose luma lies on a cell
            # boundary (to rounding) gets a weight of 0 in one package and
            # of a few ulp in the other: Adam moves it by lr or not at all
            diff = (v - want[k]).abs()
            off = diff > 1e-6 + 1e-5 * want[k].abs()
            assert float(off.float().mean()) < 0.01
            assert float(diff.max()) <= 2 * 2e-3 * AUX["max_steps"]
        else:
            close(v, want[k], what=k)
        assert not torch.equal(v, init[k]), k  # every module trained
    for k in ("pose", "bilagrid"):
        assert tr.aux_states[k]["count"] == 2


def test_runner_without_parser_reads_the_colmap_dir(runs):
    jr, tr = runs["jr"], runs["tr"]
    assert len(tr.trainset) == len(jr.trainset) == 4
    assert len(tr.valset) == len(jr.valset) == 2
    np.testing.assert_array_equal(tr.parser.camtoworlds,
                                  jr.parser.camtoworlds)
    data, jdata = tr._device_trainset(), jr._device_trainset()
    assert sorted(data) == sorted(jdata)
    for k, v in data.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdata[k]),
                                      err_msg=k)
    assert int((data["depths"] > 0).sum()) > 8  # tracks, padded to the cap
    assert data["depths"].shape == (4, AUX["depth_points_cap"])


def test_random_init_matches_jax(runs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    kw = dict(data_dir=runs["root"], init_type="random", init_num_pts=200,
              capacity=400)
    for app in (False, True):
        jr = JRunner(JConfig(result_dir=str(tmp_path / f"j{app}"),
                             app_opt=app, **kw))
        tr = Runner(Config(result_dir=str(tmp_path / f"t{app}"),
                           app_opt=app, **kw), device="cpu")
        keys = ("means", "scales", "opacities") + (
            ("colors",) if app else ("sh0", "shN"))
        for k in keys:
            np.testing.assert_array_equal(tr.splats[k].numpy(),
                                          np.asarray(jr.splats[k]),
                                          err_msg=k)
    assert float(tr.splats["means"].abs().max()) > tr.scene_scale


def test_checkpoint_aux_leaves_cross_both_ways(runs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    jr, tr = runs["jr"], runs["tr"]
    cfg = dict(data_dir=runs["root"], **AUX)
    # the port's checkpoint into a fresh JAX Runner
    path = tr.save_checkpoint(2)
    with np.load(path) as z:
        assert sorted(k for k in z.files if k.startswith("aux/")) == [
            f"aux/{i}" for i in range(7)]
    fresh_j = JRunner(JConfig(result_dir=str(tmp_path / "j"), **cfg))
    assert fresh_j.load_checkpoint(path) == 2
    back = from_jax_sim_params(jax_aux_numpy(fresh_j.aux_params),
                               device="cpu")
    for k, v in tr.aux_params.items():
        assert torch.equal(back[k], v), k
    # the JAX Runner's checkpoint into a fresh port Runner
    jr.save_checkpoint(3)
    fresh_t = Runner(Config(result_dir=str(tmp_path / "t"), **cfg),
                     device="cpu")
    assert fresh_t.load_checkpoint(os.path.join(
        jr.cfg.result_dir, "ckpts", "ckpt_3.npz")) == 3
    want = from_jax_sim_params(jax_aux_numpy(jr.aux_params), device="cpu")
    for k, v in want.items():
        assert torch.equal(fresh_t.aux_params[k], v), k
    for k, v in fresh_t.splats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jr.splats[k]))


@pytest.fixture(scope="module")
def poisoned(runs):
    """One more step of each Runner with a NaN pose row that its batch
    uses; the skips.jsonl rows."""
    jr, tr = runs["jr"], runs["tr"]
    assert POISONED_ROW in tr.view_order[:AUX["batch_size"]]
    jr.aux_params["pose"] = jr.aux_params["pose"].at[POISONED_ROW].set(
        jnp.nan)
    tr.aux_params["pose"][POISONED_ROW] = float("nan")
    before = {k: v.clone() for k, v in tr.aux_params.items()}
    jr.train(max_steps=1, log_every=0)
    tr.train(max_steps=1, log_every=0)
    rows = {}
    for name, r in (("jax", jr), ("port", tr)):
        with open(os.path.join(r.cfg.result_dir, "skips.jsonl")) as f:
            rows[name] = [json.loads(line) for line in f]
    return dict(rows=rows, before=before)


def test_skip_fingerprint_matches_jax(runs, poisoned):
    rows = poisoned["rows"]
    assert len(rows["jax"]) == len(rows["port"]) == 1
    j, t = rows["jax"][0], rows["port"][0]
    for k in ("global_step", "in_chunk", "bad_leaves"):
        assert t[k] == j[k], k
    # the NaN camera renders nothing: the loss is finite, its gradients not
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert "[2]['pose']" in t["bad_leaves"]
    tr = runs["tr"]
    assert tr.skipped_steps == 1
    for k, v in tr.aux_params.items():  # the state carried unchanged
        assert torch.equal(v.nan_to_num(), poisoned["before"][k]
                           .nan_to_num()), k


def test_skip_probe_replays_the_pre_step_state(runs, poisoned):
    t = poisoned["rows"]["port"][0]
    assert t["probe"] == PROBE_VERDICTS[0]  # the NaN row is still there
    assert t["probe_replayed"] == "the pre-step state"


def test_scalars_match_jax(runs):
    js, ts = runs["scalars"]["jax"], runs["scalars"]["port"]
    assert len(js) == len(ts) == 8  # train/* and 3 histograms a step
    for j, t in zip(js, ts):
        assert sorted(t) == sorted(j)
        assert t["step"] == j["step"] and t.get("hist") == j.get("hist")
        if "train/loss" in j:
            assert t["train/loss"] == pytest.approx(j["train/loss"],
                                                    rel=1e-5)
            for k in ("train/n_isects", "train/num_GS",
                      "train/skipped_steps"):
                assert t[k] == j[k], k
    assert [r["hist"] for r in ts if "hist" in r][:3] == [
        "params/means", "params/scales", "params/opacities"]


def test_render_traj_files_match_jax(runs):
    jpath, tpath = runs["traj"]["jax"], runs["traj"]["port"]
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert os.path.isdir(tpath)  # no mp4 writer on this host
    names = sorted(os.listdir(tpath))
    assert names == sorted(os.listdir(jpath)) and len(names) == 6
    for n in names:
        a = read_png(os.path.join(tpath, n)).astype(int)
        b = read_png(os.path.join(jpath, n)).astype(int)
        assert np.abs(a - b).max() <= 1, n


def test_eval_saves_side_by_side_images(runs, tmp_path):
    tr = runs["tr"]
    cfg = tr.cfg
    tr.cfg = dataclasses.replace(cfg, eval_save_images=True,
                                 result_dir=str(tmp_path))
    try:
        m = tr.eval("dump")
    finally:
        tr.cfg = cfg
    assert np.isfinite(m["psnr"])
    for i in range(len(tr.valset)):
        pair = read_png(str(tmp_path / "renders" / f"dump_{i:04d}.png"))
        data = tr.valset[i]
        h, w = data["image"].shape[:2]
        assert pair.shape == (h, 2 * w, 3)
        img = tr.render_view(data["camtoworld"], data["K"], w, h).numpy()
        np.testing.assert_array_equal(
            pair, (np.clip(np.concatenate([img, data["image"]], 1), 0, 1)
                   * 255).astype(np.uint8))


def test_simple_trainer_main_on_cpu(runs, tmp_path, monkeypatch):
    """The command line with typed values, from the COLMAP directory."""
    from gscodec_studio_tpu_torch import simple_trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    runner = simple_trainer.main([
        "default", "--data-dir", runs["root"], "--data-factor", "1",
        "--result-dir", str(tmp_path), "--max-steps", "3",
        "--capacity", "150", "--isect-capacity", "8192",
        "--rasterizer", "reference", "--test-every", "3",
        "--eval-steps", "2", "--save-steps", "2", "--tb-every", "1",
        "--pose-opt", "--device", "cpu"])
    cfg = runner.cfg
    assert (cfg.max_steps, cfg.capacity, cfg.eval_steps) == (3, 150, (2,))
    assert cfg.pose_opt is True and runner.device.type == "cpu"
    assert runner.splats["means"].shape[0] == 150
    for rel in ("ckpts/ckpt_2.npz", "ckpts/ckpt_3.npz", "point_cloud.ply",
                "stats/val.json", "stats/val_step2.json",
                "tb/scalars.jsonl"):
        assert (tmp_path / rel).exists(), rel


@pytest.mark.parametrize("option", ["pose_opt", "app_opt",
                                    "use_bilateral_grid", "depth_loss"])
def test_runner2dgs_refuses_per_image_modules(option, tmp_path):
    """The JAX Runner2DGS's step never applies these modules
    (gscodec_studio_tpu/training/trainer_2dgs.py:114): the port's refuses
    them, as it refuses compression_sim."""
    cfg = Config2DGS(result_dir=str(tmp_path), **{option: True})
    with pytest.raises(NotImplementedError, match=option):
        Runner2DGS(cfg, parser=object(), device="cpu")
