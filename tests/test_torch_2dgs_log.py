"""The 2DGS fused rasterizer with log_composite (the plain versions of the
2DGS tile kernels' log-space branch) against the JAX package's fused path,
whose Pallas kernels run in interpret mode on the CPU, on
tests/test_torch_2dgs.py's scene.

Tolerances, those of tests/test_torch_2dgs.py: the forward within rtol
1e-3, atol 1e-4 (distortion atol 2e-4; median rtol 1e-4, atol 1e-4); the
gradients each within 5e-3 of the reference's largest |value|. The log
scan sums its terms pair by pair here and by a matmul in JAX, so T
differs in its last bits. Also: the log branch's outputs lie within 1e-4
of the product branch's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops.raster_v2_2dgs import (
    rasterize_to_pixels_2dgs_v2 as jrasterize_2dgs)
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as t2

from tests.test_torch_2dgs import NAMES, W, H, _loss, surfels  # noqa: F401


@pytest.fixture(scope="module")
def jax_fused_log(surfels):  # noqa: F811
    """JAX's fused forward and gradients with log_composite, in interpret
    mode: one compile of value_and_grad with the forward as aux."""
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    bg, tgt = jnp.asarray(surfels["bg"]), jnp.asarray(surfels["tgt"])

    def loss(m2, M, col, op, nrm):
        out = jrasterize_2dgs(m2, M, col, op, nrm, jnp.asarray(dep),
                              jnp.asarray(radii), W, H, tile_size=16,
                              isect_capacity=8192, backgrounds=bg,
                              tiles_per_step=1, log_composite=True)
        return _loss(*out[:4], tgt, jnp), out[:5]

    (value, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, (m2, M, col, op, nrm)))
    return (float(value), [np.asarray(o) for o in outs],
            [np.asarray(g) for g in grads])


def _port(surfels, log_composite, leaves=None):  # noqa: F811
    m2, M, col, op, nrm, dep, radii = surfels["args"]
    if leaves is None:
        leaves = [torch.as_tensor(x) for x in (m2, M, col, op, nrm)]
    return t2.rasterize_to_pixels_2dgs_v2(
        *leaves, torch.as_tensor(dep), torch.as_tensor(radii), W, H,
        tile_size=16, isect_capacity=8192,
        backgrounds=torch.as_tensor(surfels["bg"]),
        log_composite=log_composite, device="cpu")


def test_fused_log_forward_matches_jax(surfels, jax_fused_log):  # noqa: F811
    _, ref, _ = jax_fused_log
    img, alp, n_img, dist, med, meta = _port(surfels, True)
    assert int(meta["n_isects"][0]) > 100
    assert int((alp > 0.05).sum()) > 50
    got = [img, alp, n_img, dist, med]
    tols = [(1e-3, 1e-4)] * 3 + [(1e-3, 2e-4), (1e-4, 1e-4)]
    print("2DGS log forward max abs (colors, alpha, normals, distortion, "
          "median):", [f"{float(np.abs(a.numpy() - b).max()):.3g}"
                       for a, b in zip(got, ref)])  # pytest -s
    for a, b, (rtol, atol) in zip(got, ref, tols):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)
    # the log scan is the product scan up to rounding
    prod = _port(surfels, False)
    for a, b in zip(got[:4], prod[:4]):
        assert float((a - b).abs().max()) <= 1e-4
    assert float((med - prod[4]).abs().max()) <= 1e-4


def test_fused_log_gradients_match_jax(surfels, jax_fused_log):  # noqa: F811
    value, _, ref = jax_fused_log
    m2, M, col, op, nrm, _, _ = surfels["args"]
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, M, col, op, nrm)]
    before = dict(tr.LAUNCHES)
    out = _port(surfels, True, leaves)
    loss = _loss(*out[:4], torch.as_tensor(surfels["tgt"]), torch)
    loss.backward()
    assert tr.LAUNCHES == before  # the CPU runs the plain versions
    assert float(loss.detach()) == pytest.approx(value, rel=2e-4)
    print("2DGS log gradients / scale:",  # pytest -s
          [f"{float(np.abs(t.grad.numpy() - b).max() / np.abs(b).max()):.3g}"
           for t, b in zip(leaves, ref)])
    for name, t, b in zip(NAMES, leaves, ref):
        a = t.grad.numpy()
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= 5e-3 * scale, name

