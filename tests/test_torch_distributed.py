"""gscodec_studio_tpu_torch.parallel against the JAX package's on the CPU,
at 2 ranks: the port's ranks are processes on the gloo backend
(parallel.launcher.spawn; tests/torch_mesh_workers.py), JAX's the devices
of make_mesh(2) over tests/conftest.py's 8 host devices, on
tests/test_distributed.py's scene (tests/torch_mesh_jax.py). Also the
exchange's autograd, the launcher and the mesh's refusals, port only.

Tolerances: the renders, dense and bucketed (cap = N/G, which covers
every visible Gaussian, and cap = 4, which drops most), within rtol 1e-4
and atol 1e-4 of JAX's (float32 in another order); the exchange's
diagnostics (overflow, sent_rows, dense_rows) of every rank exactly; the
exchange's gradient exactly (it moves values, it sums nothing).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.parallel import distributed_render as jrender
from gscodec_studio_tpu.parallel import make_mesh as jmake_mesh
from gscodec_studio_tpu_torch.parallel import launcher
from gscodec_studio_tpu_torch.parallel.distributed import (Mesh, make_mesh,
                                                           shard_rows)
from tests import torch_mesh_jax as J
from tests import torch_mesh_workers as workers

G = 2


def check_renders(G):
    """The port's renders and diagnostics at G ranks against JAX's."""
    splats, vm, Ks, _ = J.scene()
    caps = [None, J.N // G, 4]
    outs = launcher.spawn(workers.render_ranks, G, splats, vm, Ks, J.W, J.H,
                          caps)
    mesh = jmake_mesh(G)
    jsp = {k: jnp.asarray(v) for k, v in splats.items()}
    for i, cap in enumerate(caps):
        ref = np.asarray(jrender(mesh, jsp, jnp.asarray(vm), jnp.asarray(Ks),
                                 J.W, J.H, sh_degree=1, isect_capacity=8192,
                                 exchange_cap=cap))
        for r in range(G):  # every rank holds every camera's render
            np.testing.assert_allclose(outs[r][i][0].numpy(), ref,
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"cap {cap}, rank {r}")
        if cap is None:
            want = np.tile([0, J.C * J.N // G, J.C * J.N // G], (G, 1))
        else:
            want = J.exchange_diags(mesh, splats, vm, Ks, cap)
        got = np.array([[outs[r][i][1][k] for k in ("overflow", "sent_rows",
                                                    "dense_rows")]
                        for r in range(G)])
        np.testing.assert_array_equal(got, want, err_msg=f"cap {cap}")
    assert outs[0][2][1]["overflow"] > 0  # cap 4 drops visible rows


def test_distributed_render_matches_jax_2_ranks():
    check_renders(G)


def _exchange_grad(rank, world):
    """The dense and bucketed exchanges' outputs and input gradients for a
    loss weighted by the receiving rank and the position."""
    from gscodec_studio_tpu_torch.parallel.distributed import (
        _exchange, _exchange_bucketed)

    mesh = make_mesh(world, device="cpu")
    C, Nl, F = 4, 3, 2
    x = (torch.arange(C * Nl * F, dtype=torch.float32).reshape(C, Nl, F)
         + 100 * rank).requires_grad_(True)
    y = _exchange(mesh, x)
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
        * (rank + 1)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    radii = torch.zeros(C, Nl, dtype=torch.int32)
    radii[:, 1] = 2  # one visible Gaussian a rank
    yb, rb, diag = _exchange_bucketed(mesh, x, radii, 2)
    (gb,) = torch.autograd.grad((yb * (rank + 1)).sum(), x)
    return y.detach(), gx, yb.detach(), rb, gb, {
        k: int(v) for k, v in diag.items()}


def test_exchange_moves_blocks_and_gradients_back():
    outs = launcher.spawn(_exchange_grad, 2)
    C, Nl, F = 4, 3, 2
    xs = [torch.arange(C * Nl * F, dtype=torch.float32).reshape(C, Nl, F)
          + 100 * r for r in range(2)]
    for r in range(2):
        y, gx, yb, rb, gb, diag = outs[r]
        # rank r receives its cameras' rows of every rank, source-major
        want = torch.cat([x[r * 2:(r + 1) * 2] for x in xs], 1)
        assert torch.equal(y, want)
        # the gradient of rank s's input is the reverse exchange: camera
        # block d holds rank d's weights for the rows that came from s
        for d in range(2):
            w = torch.arange(2 * 2 * Nl * F, dtype=torch.float32).reshape(
                2, 2 * Nl, F) * (d + 1)
            assert torch.equal(gx[d * 2:(d + 1) * 2],
                               w[:, r * Nl:(r + 1) * Nl])
        # bucketed at cap 2: the visible row (1) first, then row 0, whose
        # radius is zeroed; each destination's rows from each source
        for s in range(2):
            got = yb[:, s * 2:(s + 1) * 2]
            assert torch.equal(got, xs[s][r * 2:(r + 1) * 2][:, [1, 0]])
        assert rb.tolist() == [[2, 0, 2, 0]] * 2
        assert diag == {"overflow": 0, "sent_rows": 8, "dense_rows": 12}
        # rows 1 and 0 of every camera went out, once, to the camera's
        # rank, which weighted them by its rank + 1; row 2 stayed home
        want_g = torch.zeros(C, Nl, F)
        for d in range(2):
            want_g[d * 2:(d + 1) * 2, :2] = d + 1
        assert torch.equal(gb, want_g)


def test_launcher_single_process(monkeypatch):
    """cli() runs the payload with (rank, world, devices) in one process
    with none of torchrun's variables set, joins no group and leaves none
    (tests/test_distributed.py:121's contract)."""
    for k in launcher.ENV:
        monkeypatch.delenv(k, raising=False)
    seen = {}

    def payload(rank, world, devices, extra):
        seen.update(rank=rank, world=world, devices=devices, extra=extra)
        mesh = launcher.make_global_mesh(device="cpu")
        assert (mesh.rank, mesh.size) == (0, 1)
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(mesh.all_to_all(x), x)
        assert torch.equal(mesh.all_gather(x), x)
        assert torch.equal(shard_rows(mesh, x), x)
        return rank

    assert launcher.cli(payload, "x", backend="gloo", device="cpu") == 0
    assert seen == {"rank": 0, "world": 1,
                    "devices": [torch.device("cpu")], "extra": "x"}
    assert not torch.distributed.is_initialized()
    assert launcher.init_multihost("gloo") is False


def _cli_rank(rank, world):
    """cli() under a group that spawn made: it runs the payload and
    destroys the group (spawn's own destroy then finds none)."""
    seen = launcher.cli(lambda r, w, d: (r, w, d), backend="gloo",
                        device="cpu")
    return seen, torch.distributed.is_initialized()


def test_launcher_in_a_group():
    outs = launcher.spawn(_cli_rank, 2)
    assert outs == [((r, 2, [torch.device("cpu")]), False) for r in range(2)]


def test_mesh_refusals():
    with pytest.raises(ValueError, match="a process group of that size"):
        make_mesh(2, device="cpu")
    assert make_mesh(device="cpu") == Mesh(0, 1, torch.device("cpu"))
