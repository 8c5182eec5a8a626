"""The port's distributed_train_step at 2 ranks against the JAX package's
on the CPU (spawned gloo ranks against make_mesh(2) over
tests/conftest.py's 8 host devices), dense and bucketed with a covering
cap (N/G), from tests/test_distributed.py's scene
(tests/torch_mesh_jax.py) and fresh Adam states.

Tolerances: the loss within rtol 1e-5; every parameter after the step
within rtol 1e-4 and atol 1e-5 (Adam's first step moves a parameter by
about lr * sign(gradient), which holds where the gradients are real: the
scene's k-NN initial scales are isotropic, which makes the quaternions'
true gradient zero and its computed value rounding noise, so both sides
start from the same anisotropic scales); the exchange's diagnostics, the
largest over the ranks, exactly.
"""

import numpy as np

import jax.numpy as jnp

from gscodec_studio_tpu.optimizers import build_splat_optimizers
from gscodec_studio_tpu.parallel import distributed_train_step as jstep
from gscodec_studio_tpu.parallel import make_mesh as jmake_mesh
from gscodec_studio_tpu_torch.parallel import launcher
from tests import torch_mesh_jax as J
from tests import torch_mesh_workers as workers

G = 2


def test_distributed_train_step_matches_jax():
    splats, vm, Ks, targets = J.scene()
    rng = np.random.default_rng(5)
    splats["scales"] = rng.normal(-2.0, 0.4, splats["scales"].shape).astype(
        np.float32)
    caps = [None, J.N // G]
    outs = launcher.spawn(workers.step_ranks, G, splats, targets, vm, Ks,
                          caps)
    mesh = jmake_mesh(G)
    jsp = {k: jnp.asarray(v) for k, v in splats.items()}
    txs, opt = build_splat_optimizers(jsp)
    for i, cap in enumerate(caps):
        p, _, loss, diag = jstep(mesh, jsp, opt, txs, jnp.asarray(targets),
                                 jnp.asarray(vm), jnp.asarray(Ks),
                                 sh_degree=1, isect_capacity=4096,
                                 exchange_cap=cap)
        for r in range(G):
            got_loss, got_p, got_diag = outs[r][i]
            np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5,
                                       err_msg=f"cap {cap}")
            for k in p:
                np.testing.assert_allclose(got_p[k].numpy(),
                                           np.asarray(p[k]), rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"cap {cap}: {k}")
            assert [got_diag[k] for k in ("overflow", "sent_rows",
                                          "dense_rows")] == \
                [int(diag[k]) for k in ("overflow", "sent_rows",
                                        "dense_rows")], cap
