"""The port's viewer (utils/viewer.py) and its last entry points on the
CPU: the viewer answers a request on 127.0.0.1 with a frame that decodes
to the render it asked for (bit for bit through png_io's PNG, the encoder
where imageio does not import; a JPEG of the same size through imageio
where it does), and ply_loader_renderer, simple_viewer, image_fitting,
ges_tm_anchor and exchange_cap_sweep each run from their command lines on
``--device cpu`` at a tiny size. The viewer's orbit camera equals the JAX
package's."""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from gscodec_studio_tpu.utils import viewer as jviewer
from gscodec_studio_tpu_torch import (exchange_cap_sweep, ges_tm_anchor,
                                      image_fitting, ply_loader_renderer,
                                      simple_viewer)
from gscodec_studio_tpu_torch.compression import ges_tm
from gscodec_studio_tpu_torch.compression.png_io import read_png
from gscodec_studio_tpu_torch.training.trainer import Runner
from gscodec_studio_tpu_torch.utils import viewer
from gscodec_studio_tpu_torch.utils.ply import save_ply
from tests import torch_mesh_workers as workers

SMALL = ["--device", "cpu", "--width", "48", "--height", "32"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: the suite runs several test files at
    once, and a thread pool a process beside them slowed this file's
    training loops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_orbit_camera_matches_jax():
    for args in ((0.6, 0.4, 4.0), (-2.0, 1.2, 0.5), (0.0, 1.5, 3.0)):
        c = np.array([0.1, -0.2, 0.3], np.float32)
        np.testing.assert_array_equal(viewer._orbit_c2w(*args, c),
                                      jviewer._orbit_c2w(*args, c))


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, dict(r.headers), r.read()


@pytest.mark.parametrize("encoder", ["png_io", "imageio"])
def test_viewer_answers_with_the_render(tmp_path, monkeypatch, encoder):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    if encoder == "png_io":
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v2", None)
    else:
        pytest.importorskip("imageio")
    scene = workers.MeshScene()
    trainset, valset = scene.split()
    runner = Runner(workers.mesh_config(str(tmp_path), batch_size=1),
                    parser=scene, trainset=trainset, valset=valset,
                    device="cpu")
    v = viewer.SplatViewer(lambda c2w, K, w, h: runner.render_view(
        c2w, K, w, h), width=32, height=24, radius=4.0)
    port = v.start(port=0, host="127.0.0.1")
    try:
        q = "theta=0.3&phi=0.2&radius=4.5&cx=0.1&cy=0&cz=0"
        status, headers, body = _get(f"http://127.0.0.1:{port}/render?{q}")
        page = _get(f"http://127.0.0.1:{port}/")
    finally:
        v.stop()
    assert status == 200 and headers["X-Encoder"] == encoder
    assert page[0] == 200 and b"/render?theta=" in page[2]
    c2w, K = v.camera({k: [x] for k, x in (p.split("=") for p in
                                           q.split("&"))})
    want = (np.clip(runner.render_view(c2w, K, 32, 24).numpy(), 0, 1)
            * 255).astype(np.uint8)
    assert want.std() > 0
    if encoder == "png_io":
        assert headers["Content-Type"] == "image/png"
        (tmp_path / "f.png").write_bytes(body)
        np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")),
                                      want)
    else:
        import imageio.v2 as imageio

        assert headers["Content-Type"] == "image/jpeg"
        got = np.asarray(imageio.imread(body, format="jpeg"))
        assert got.shape == want.shape
        assert np.abs(got.astype(float) - want).mean() < 12  # JPEG's loss


@pytest.fixture(scope="module")
def ply_files(tmp_path_factory):
    """Two PLYs of 200 random SH-3 Gaussians, the second perturbed, and
    the first as a flat splat npz."""
    d = tmp_path_factory.mktemp("plys")
    rng = np.random.default_rng(11)
    n = 200
    s = dict(means=rng.standard_normal((n, 3)).astype(np.float32),
             quats=rng.standard_normal((n, 4)).astype(np.float32),
             scales=rng.normal(-2.5, 0.3, (n, 3)).astype(np.float32),
             opacities=rng.normal(1.0, 1.0, n).astype(np.float32),
             sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
             shN=(0.1 * rng.standard_normal((n, 15, 3))).astype(np.float32))
    save_ply(str(d / "a.ply"), s)
    s2 = dict(s, sh0=s["sh0"] + 0.05)
    save_ply(str(d / "b.ply"), s2)
    np.savez(d / "a.npz", **s)
    return d


def test_ply_loader_renderer(ply_files, tmp_path):
    out = ply_loader_renderer.main(
        ["--ply", str(ply_files / "a.ply"), "--ref_ply",
         str(ply_files / "b.ply"), "--out_dir", str(tmp_path),
         "--n_views", "2", "--save_images"] + SMALL)
    assert np.isfinite(out["psnr_rgb"]) and out["psnr_rgb"] > 10
    assert json.load(open(tmp_path / "metrics.json")) == out
    assert sorted(os.listdir(tmp_path)) == [
        "f0000_v00.png", "f0000_v01.png", "metrics.json"]
    assert read_png(str(tmp_path / "f0000_v00.png")).shape == (32, 48, 3)


def test_simple_viewer_frames(ply_files, tmp_path):
    paths = simple_viewer.main(["--ply", str(ply_files / "a.ply"),
                                "--output_dir", str(tmp_path),
                                "--n_frames", "2"] + SMALL)
    assert len(paths) == 2
    imgs = [read_png(p) for p in paths]
    assert imgs[0].shape == (32, 48, 3) and imgs[0].std() > 0
    assert not np.array_equal(imgs[0], imgs[1])


def test_image_fitting_descends(tmp_path):
    out = image_fitting.main(["--num_points", "300", "--iterations", "15",
                              "--width", "32", "--height", "32",
                              "--save_path", str(tmp_path / "fit.png"),
                              "--device", "cpu"])
    assert out["mse_last"] < out["mse_first"]
    assert read_png(str(tmp_path / "fit.png")).shape == (32, 32, 3)


def test_ges_tm_anchor_quant_only(ply_files, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("GES_TM_TMC3", raising=False)
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    if ges_tm.find_tmc3() is not None:
        pytest.skip("a tmc3 binary is on PATH")
    rows = ges_tm_anchor.main(["--ply", str(ply_files / "a.ply"), "--out",
                               str(tmp_path), "--n-views", "2", "--device",
                               "cpu", "--width", "48", "--height", "32"])
    assert "no tmc3 binary" in capsys.readouterr().out
    assert len(rows) == 1 and "tmc3 unavailable" in rows[0]["rate_point"]
    assert np.isfinite(rows[0]["psnr_vs_uncompressed"])
    assert json.load(open(tmp_path / "ges_tm_results.json")) == rows


def test_exchange_cap_sweep_counts_live_groups(ply_files, tmp_path):
    """4 simulated ranks and 2 views: camera groups of one view, two of
    them without a camera, which ship nothing; a cap past every shard's
    rows keeps every visible row (the uncapped render)."""
    out = exchange_cap_sweep.main(
        ["--splats", str(ply_files / "a.npz"), "--caps", "8", "64",
         "--mesh", "4", "--n_views", "2", "--out",
         str(tmp_path / "sweep.json"), "--isect_capacity", "65536"]
        + SMALL)
    assert out["live_groups"] == 2 and out["n_gaussians"] == 200
    small, big = out["rows"]
    assert small["sent_over_dense"] == 2 * 4 * 8 / (2 * 200)
    assert big["sent_over_dense"] == 2 * 4 * 64 / (2 * 200)
    assert small["dropped_visible_rows"] > 0
    assert big["dropped_visible_rows"] == 0
    assert big["psnr_vs_uncapped"] >= 100  # equal renders (psnr caps at 120)
    assert np.isfinite(small["psnr_vs_uncapped"])
    assert json.load(open(tmp_path / "sweep.json"))["rows"][0] == small
