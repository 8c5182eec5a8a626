"""The port's quality metrics and profiling helpers against the JAX
package on the CPU: training/losses.ms_ssim at even and odd sizes and at
sizes too small for five scales, utils/gsc_metrics.gsc_metrics,
utils/ply_render.sequence_metrics over two frames on the reference
rasterizer, and utils/profiling's timeit, report, trace and honest_timer.

Tolerances: MS-SSIM and the SSIMs 1e-5 relative (two float32 blurs that
sum in another order); the PSNRs, computed in numpy on the same arrays,
equal to 1e-9 relative; sequence_metrics' PSNRs within 0.01 dB and its
SSIMs within 1e-4 (two renders that agree to 1e-4); the profiling
helpers' counts equal and their times positive, honest_timer exact on a
counting clock.
"""

import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.training import losses as jlosses
from gscodec_studio_tpu.utils import gsc_metrics as jgsc
from gscodec_studio_tpu.utils import ply_render as jply
from gscodec_studio_tpu.utils import profiling as jprof
from gscodec_studio_tpu_torch.training import losses as tlosses
from gscodec_studio_tpu_torch.utils import gsc_metrics as tgsc
from gscodec_studio_tpu_torch.utils import ply_render as tply
from gscodec_studio_tpu_torch.utils import profiling as tprof


def _pair(rng, shape):
    a = rng.random(shape, dtype=np.float32)
    noise = rng.normal(0, 0.08, shape).astype(np.float32)
    return a, np.clip(a + noise, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("shape,scales", [
    ((1, 176, 176, 3), 5),  # even: five scales
    ((1, 181, 179, 1), 5),  # odd: each halving drops a row and a column
    ((1, 88, 90, 3), 4),
    ((1, 40, 50, 3), 2),  # too small for five scales
    ((1, 12, 13, 1), 1),  # one scale: plain SSIM
])
def test_ms_ssim_matches_jax(rng, shape, scales):
    a, b = _pair(rng, shape)
    n = len(tlosses._MSSSIM_WEIGHTS)
    while n > 1 and min(shape[1:3]) // (2 ** (n - 1)) < 11:
        n -= 1
    assert n == scales
    got = float(tlosses.ms_ssim(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(jlosses.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(tlosses.ms_ssim(torch.as_tensor(a), torch.as_tensor(a))) \
        == pytest.approx(1.0, abs=1e-5)
    if scales == 1:
        assert got == pytest.approx(float(tlosses.ssim(
            torch.as_tensor(a), torch.as_tensor(b))), rel=1e-6)


def test_ms_ssim_pool_drops_the_odd_edge():
    """The 2x2 mean between scales takes whole 2x2 blocks, as JAX's VALID
    reduce_window does: a value in the odd last row never reaches the
    next scale."""
    x = torch.zeros((1, 5, 7, 1))
    x[0, 4, :, 0] = 1.0
    x[0, :, 6, 0] = 1.0
    pooled = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    assert pooled.shape == (1, 1, 2, 3) and float(pooled.abs().max()) == 0.0


def test_gsc_metrics_match_jax(rng):
    ref, dist = _pair(rng, (96, 80, 3))
    got = tgsc.gsc_metrics(ref, dist, device="cpu")
    want = jgsc.gsc_metrics(ref, dist)
    assert set(got) == set(want) == {"psnr_rgb", "psnr_y", "psnr_cb",
                                     "psnr_cr", "ssim_y", "msssim_y"}
    for k in ("psnr_rgb", "psnr_y", "psnr_cb", "psnr_cr"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    for k in ("ssim_y", "msssim_y"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    np.testing.assert_array_equal(tgsc.rgb_to_ycbcr(ref),
                                  jgsc.rgb_to_ycbcr(ref))


def _frame(rng, n=300):
    return dict(
        means=(rng.random((n, 3)) * 2 - 1).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=np.log(0.03 + 0.08 * rng.random((n, 3))).astype(np.float32),
        opacities=rng.normal(1, 1, n).astype(np.float32),
        sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.1, (n, 3, 3)).astype(np.float32),
    )


def test_sequence_metrics_match_jax(rng):
    frames = [_frame(rng), _frame(rng)]
    decoded = [{k: (v + rng.normal(0, 0.02, v.shape)).astype(np.float32)
                for k, v in f.items()} for f in frames]
    cams = jply.orbit_cameras(frames[0]["means"], n_views=2, width=48,
                              height=32)
    kw = dict(isect_capacity=1 << 15, rasterizer="reference")
    want = jply.sequence_metrics(frames, decoded, cams, **kw)
    got = tply.sequence_metrics(frames, decoded, cams, device="cpu", **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        tol = 0.01 if k.startswith("psnr") else 1e-4
        assert got[k] == pytest.approx(v, abs=tol), k
    assert 10.0 < got["psnr_rgb"] < 60.0


def test_profiling_helpers_match_jax(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("TIMEIT", "1")
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod, "TIMINGS", type(mod.TIMINGS)(float))
        monkeypatch.setattr(mod, "COUNTS", type(mod.COUNTS)(int))

        @mod.timeit_decorator()
        def work():
            time.sleep(0.002)

        for _ in range(3):
            work()
        with mod.timeit("block"):
            time.sleep(0.001)
    assert dict(tprof.COUNTS) == dict(jprof.COUNTS) == {
        "test_profiling_helpers_match_jax.<locals>.work": 3, "block": 1}
    assert min(tprof.TIMINGS.values()) > 0
    capsys.readouterr()
    jprof.report()
    want = capsys.readouterr().out
    tprof.report()
    got = capsys.readouterr().out
    assert [ln.split()[0] for ln in got.splitlines()] == \
        [ln.split()[0] for ln in want.splitlines()]
    monkeypatch.setenv("TIMEIT", "0")
    with tprof.timeit("off"):
        pass
    assert "off" not in tprof.COUNTS

    # honest_timer on a clock that a body call advances by 1 and each
    # reading by 0.125 (a fixed cost a run): exactly 1 an iteration
    clock = [0.0]

    def perf_counter():
        clock[0] += 0.125
        return clock[0]

    def body(c, step):
        clock[0] += step
        return c + 1

    monkeypatch.setattr(tprof, "time", types.SimpleNamespace(
        perf_counter=perf_counter))
    assert tprof.honest_timer(body, (1.0,), K=8, repeats=2,
                              device="cpu") == pytest.approx(1.0)
    monkeypatch.undo()
    x = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(tprof.honest_timer(
        lambda c, m: c + (m @ m)[0, 0] * 0, (x,), K=4, repeats=1,
        device="cpu"))
    with tprof.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
