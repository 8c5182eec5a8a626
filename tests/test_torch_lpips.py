"""The port's LPIPS (training/lpips.py) against the JAX package's on the
CPU, on random weights in the npz layout drawn here (no pretrained nets
ship with the repository), and in Runner.eval: an ``lpips`` entry with
weights at GSC_LPIPS_WEIGHTS, one printed notice without.

Tolerance: the distance within 1e-5 absolute (float32 convolutions in
another order)."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.training import lpips as jlpips
from gscodec_studio_tpu_torch.training import lpips as tlpips
from gscodec_studio_tpu_torch.training.trainer import Runner
from tests import torch_mesh_workers as workers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: the suite runs several test files at
    once, and a thread pool a process beside them slowed this file's
    training loops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_weights(seed=0):
    rng = np.random.default_rng(seed)
    w, cin = {}, 3
    for i, (c, k, _, _) in enumerate(tlpips._ALEX):
        w[f"conv{i}_w"] = (rng.standard_normal((k, k, cin, c))
                           / np.sqrt(k * k * cin)).astype(np.float32)
        w[f"conv{i}_b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        # signed: the heads clamp at 0
        w[f"lin{i}_w"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        cin = c
    return w


@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 72, 96)])
def test_lpips_matches_jax(shape):
    assert tlpips._ALEX == jlpips._ALEX
    assert tlpips._POOL_AFTER == jlpips._POOL_AFTER
    w = random_weights()
    rng = np.random.default_rng(1)
    a = rng.random(shape + (3,)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ref = float(jlpips.lpips(jnp.asarray(a), jnp.asarray(b),
                             {k: jnp.asarray(v) for k, v in w.items()}))
    got = float(tlpips.lpips(torch.as_tensor(a), torch.as_tensor(b),
                             {k: torch.as_tensor(v) for k, v in w.items()}))
    assert ref > 0 and abs(got - ref) <= 1e-5
    same = float(tlpips.lpips(torch.as_tensor(a), torch.as_tensor(a),
                              {k: torch.as_tensor(v) for k, v in w.items()}))
    assert same == 0.0


def test_weights_gate(tmp_path, monkeypatch):
    path = tmp_path / "alex.npz"
    monkeypatch.setenv("GSC_LPIPS_WEIGHTS", str(path))
    assert not tlpips.lpips_available()
    with pytest.raises(FileNotFoundError, match="GSC_LPIPS_WEIGHTS"):
        tlpips.load_lpips_weights(device="cpu")
    np.savez(path, **random_weights())
    assert tlpips.lpips_available()
    w = tlpips.load_lpips_weights(device="cpu")
    assert w["conv0_w"].shape == (11, 11, 3, 64)
    assert w["conv0_w"].dtype == torch.float32


def test_runner_eval_lpips(tmp_path, monkeypatch, capsys):
    """eval() without weights: PSNR and SSIM, and the notice once; with
    them an ``lpips`` entry equal to the metric on the held-out render."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("GSC_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    scene = workers.MeshScene(width=64, height=64)  # AlexNet's least size
    trainset, valset = scene.split()
    cfg = workers.mesh_config(str(tmp_path / "run"), batch_size=1)
    runner = Runner(cfg, parser=scene, trainset=trainset, valset=valset,
                    device="cpu")
    assert set(runner.eval("a")) == {"psnr", "ssim"}
    assert set(runner.eval("b")) == {"psnr", "ssim"}
    assert capsys.readouterr().out.count("lpips SKIPPED") == 1
    w = random_weights(2)
    np.savez(tmp_path / "alex.npz", **w)
    monkeypatch.setenv("GSC_LPIPS_WEIGHTS", str(tmp_path / "alex.npz"))
    m = runner.eval("c")
    d = valset[0]
    img = runner.render_view(d["camtoworld"], d["K"], 64, 64)
    want = float(tlpips.lpips(img[None], torch.as_tensor(d["image"])[None],
                              {k: torch.as_tensor(v) for k, v in w.items()}))
    assert m["lpips"] == pytest.approx(want, rel=1e-6) and want > 0
