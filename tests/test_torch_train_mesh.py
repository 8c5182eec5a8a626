"""The Runner's mesh mode on the CPU, port only: 2 ranks, each a process
on the gloo backend (parallel.launcher.spawn; tests/torch_mesh_workers.py),
on a small numpy scene (96 points, 5 views of 32x24, random targets).

  * A dense mesh step equals the single-device Runner's step on the same
    batch: the loss within rtol 1e-4, the batch's render within
    tests/test_distributed.py's rtol 1e-3 and atol 2e-3, the
    densification statistic grad2d within 1e-4 of its largest value and
    the parameters after the step within rtol 1e-4 and atol 1e-5 (from
    anisotropic scales: test_torch_train.py's reason). Measured on the
    CPU: the loss, the render and the parameters equal to the bit, grad2d
    within 1.2e-10 of 3.9e-3.
  * After refines (the default strategy's growth, MCMC's relocation under
    the compression simulation) the ranks hold the same bits of the whole
    model, its Adam moments, its strategy state and the simulation's
    parameters; the loss is finite and the eval's PSNR too.
  * Checkpoints, the PLY and the PNG codec run on the gathered model, and
    rank 0 alone writes (a checkpoint saved and loaded gives each rank its
    rows back).
  * The dryrun (parallel/dryrun.py) at 2 ranks at a reduced shape: 4,000
    Gaussians at 64x64, exchange_cap 256, so that the overflow fires.
"""

import math

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.parallel import launcher
from tests import torch_mesh_workers as workers

G = 2


def test_mesh_step_equals_single_device_step(tmp_path):
    (out,) = launcher.spawn(workers.runner_step_ranks, G, str(tmp_path))[:1]
    s, m = out["single"], out["mesh"]
    assert m["exchange"]["overflow"] == 0
    np.testing.assert_allclose(m["loss"], s["loss"], rtol=1e-4)
    np.testing.assert_allclose(m["render"].numpy(), s["render"].numpy(),
                               rtol=1e-3, atol=2e-3)
    g = s["grad2d"]
    assert float((m["grad2d"] - g).abs().max()) <= 1e-4 * float(
        g.abs().max())
    for k, v in s["splats"].items():
        np.testing.assert_allclose(m["splats"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("strategy", ["default", "mcmc"])
def test_mesh_refine_keeps_ranks_equal(tmp_path, strategy):
    a, b = launcher.spawn(workers.runner_refine_ranks, G, str(tmp_path),
                          strategy)
    for key in ("splats", "strategy_state", "sim"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for k in a["moments"]:
        for m in a["moments"][k]:
            assert torch.equal(a["moments"][k][m], b["moments"][k][m]), k
    assert a["losses"] == b["losses"] and a["events"] == b["events"]
    refines = [e for e in a["events"] if e["event"] == "refine"]
    assert [e["step"] for e in refines] == [2, 4]
    if strategy == "default":  # the lowered threshold grows
        assert refines[-1]["live"] > refines[0]["live"] > 96
    else:
        assert refines[-1]["allocated"] > refines[0]["allocated"] > 96
    assert all(math.isfinite(x) for x in a["losses"])
    assert a["eval"] == b["eval"] and math.isfinite(a["eval"]["psnr"])
    for r in (a, b):
        assert r["ckpt_step"] == 4 and r["reloaded"]
    assert {"ckpts", "point_cloud.ply", "stats", "tb"} <= set(a["files"])
    if strategy == "default":
        assert a["compression"] == b["compression"]
        assert a["compression"]["size_bytes"] > 0
        assert "compression_4" in a["files"]


def _dryrun(rank, world):
    torch.set_num_threads(1)
    from gscodec_studio_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(world, n_gauss=4000, wh=(64, 64), device="cpu",
                            exchange_cap=256)


def test_dryrun_multichip_reduced():
    outs = launcher.spawn(_dryrun, G)
    assert outs[0] == outs[1]
    out = outs[0]
    assert math.isfinite(out["loss"]) and out["exchange"]["overflow"] > 0
    assert out["exchange"]["sent_rows"] == 2 * 1 * 256
    assert out["exchange"]["dense_rows"] == 2 * 2000


def test_mesh_refusals(tmp_path):
    """Runner2DGS has no mesh mode (nor has the JAX package's), and the
    mesh renders through the fused backend only; both raise before the
    Runner reads its scene."""
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner
    from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                                Runner2DGS)

    with pytest.raises(ValueError, match="Runner2DGS has no mesh mode"):
        Runner2DGS(Config2DGS(result_dir=str(tmp_path), mesh_devices=2,
                              batch_size=2), parser=object(), device="cpu")
    with pytest.raises(ValueError, match="fused backend only"):
        Runner(Config(result_dir=str(tmp_path), mesh_devices=2,
                      batch_size=2, rasterizer="pallas"), parser=object(),
               device="cpu")
