"""The JAX side of the port's mesh tests: the numpy scene of
tests/test_distributed.py (128 Gaussians of SH degree 1, 16x16, here 4
cameras so that they split over 2 and 4 ranks), JAX's distributed render
and train step on make_mesh(G) over tests/conftest.py's 8 host devices,
and the per-device diagnostics of its bucketed exchange."""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gscodec_studio_tpu.models.splats import create_splats, splat_activations
from gscodec_studio_tpu.ops.projection import fully_fused_projection
from gscodec_studio_tpu.parallel.distributed import AXIS, _exchange_bucketed
from tests.conftest import make_test_scene

N, C, W, H = 128, 4, 16, 16


def scene():
    """(splats as numpy, viewmats, Ks, targets): test_distributed.py's
    recipe, seed 1234."""
    rng = np.random.default_rng(1234)
    pts = (rng.random((N, 3)).astype(np.float32) - 0.5) * 2
    rgb = rng.random((N, 3)).astype(np.float32)
    splats = create_splats(pts, rgb, cap=N, sh_degree=1, init_opacity=0.6,
                           init_scale=2.0)
    s = make_test_scene(rng, C=C, N=N, width=W, height=H)
    targets = rng.random((C, H, W, 3)).astype(np.float32)
    return ({k: np.asarray(v) for k, v in splats.items()}, s["viewmats"],
            s["Ks"], targets)


def exchange_diags(mesh, splats, viewmats, Ks, cap):
    """Each device's (overflow, sent_rows, dense_rows) of the bucketed
    exchange of rasterize_sharded's projection: [G, 3]."""

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(AXIS), P(), P()),
                       out_specs=P(AXIS), check_vma=False)
    def run(sp, vm, K):
        means, quats, scales, opac = splat_activations(sp)
        radii, means2d, *_ = fully_fused_projection(
            means, None, quats, scales, vm, K, W, H, opacities=opac)
        radii = jnp.where(opac[None, :] >= 1.0 / 255.0, radii, 0)
        _, _, d = _exchange_bucketed({"m": means2d}, radii, cap)
        return jnp.stack([d["overflow"], d["sent_rows"],
                          d["dense_rows"]])[None]

    return np.asarray(jax.jit(run)(
        {k: jnp.asarray(v) for k, v in splats.items()},
        jnp.asarray(viewmats), jnp.asarray(Ks)))
