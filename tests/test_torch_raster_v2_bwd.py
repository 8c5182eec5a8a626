"""The backward of gscodec_studio_tpu_torch's fused rasterizer (the plain
versions of the tile-backward, unpack and segment-sum kernels) against
jax.grad of the JAX package's rasterize_to_pixels_v2 and rasterization,
whose Pallas kernels run in interpret mode on the CPU, on the same numpy
inputs.

Tolerances, each relative to the largest |value| of the reference
gradient tensor (its scale):
  * rasterize_to_pixels_v2 against JAX: >= 99% of the entries within 1e-4
    and all within 5e-3. Most entries agree to ~1e-6. Two effects make the
    rest: an exp or product ulp can move a pair across the 1e-4
    transmittance cutoff or the 1/255 alpha test, which shifts that
    Gaussian's gradient by up to ~1.2e-3 (measured, truncation case); and
    without absgrad the JAX kernel takes the geometry rows from pixel
    moments, whose cancellation at tile 32 leaves up to 2.5e-4 on ~0.4% of
    the conic entries (measured).
  * against the port's dense oracle (few pairs, no flips): every entry
    within 1e-4.
  * rasterization (through projection and SH): every entry within 1e-3,
    since the raster gradients are amplified by the projection's
    Jacobians.
  * the unpack plain version: bit for bit; the segment sums: max abs <=
    1e-6 of the largest |sum| (another summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import raster_v2 as jr
from gscodec_studio_tpu.rendering import rasterization as jrasterization
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref
from gscodec_studio_tpu_torch.rendering import rasterization

from tests.conftest import make_test_scene
from tests.test_rasterize_pallas import make_2d_scene

W, H = 96, 64


def assert_grad_close(port, ref, tol, name="", worst=None, frac=0.0):
    """|port - ref| <= tol * scale for all but ``frac`` of the entries, and
    <= worst * scale for every entry (worst defaults to tol)."""
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(port - ref) / scale
    assert err.max() <= (worst or tol), (name, err.max())
    assert (err > tol).mean() <= frac, (name, (err > tol).mean())


def assert_raster_grad_close(port, ref, name):
    assert_grad_close(port, ref, 1e-4, name, worst=5e-3, frac=0.01)


def _elliptical(rng, radii):
    ry = np.maximum(radii - rng.integers(0, 4, radii.shape), 0)
    return np.stack([radii, ry], -1).astype(np.int32)


def _raster_case(rng, C, CH, N=600):
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=C, N=N, W=W, H=H,
                                                   CH=CH)
    ct = rng.standard_normal((C, H, W, CH)).astype(np.float32)
    ca = rng.standard_normal((C, H, W, 1)).astype(np.float32)
    return (m2, con, col, op, dep, _elliptical(rng, rad), bg), ct, ca


def _port_grads(args, ct, ca, absgrad, **kw):
    m2, con, col, op, dep, radii, bg = args
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, con, col, op, bg)]
    probe = torch.zeros(m2.shape, requires_grad=True) if absgrad else None
    img, alp, meta = tr.rasterize_to_pixels_v2(
        *leaves[:4], dep, radii, W, H, backgrounds=leaves[4],
        absgrad_probe=probe, device="cpu", **kw)
    ((img * torch.as_tensor(ct)).sum()
     + (alp * torch.as_tensor(ca)).sum()).backward()
    return [t.grad for t in leaves] + ([probe.grad] if absgrad else []), meta


def _jax_grads(args, ct, ca, absgrad, **kw):
    m2, con, col, op, dep, radii, bg = args

    def loss(m2, con, col, op, bg, probe):
        img, alp, _ = jr.rasterize_to_pixels_v2(
            m2, con, col, op, jnp.asarray(dep), jnp.asarray(radii), W, H,
            backgrounds=bg, absgrad_probe=probe if absgrad else None,
            tiles_per_step=1, **kw)  # one tile per grid step compiles faster
        return jnp.sum(img * ct) + jnp.sum(alp * ca)

    g = jax.jit(jax.grad(loss, argnums=tuple(range(6 if absgrad else 5))))(
        *map(jnp.asarray, (m2, con, col, op, bg)),
        jnp.zeros(m2.shape, jnp.float32))
    return g


NAMES = ("means2d", "conics", "colors", "opacities", "backgrounds",
         "absgrad")


@pytest.mark.parametrize(
    "ts,cutoff,C,CH,use_masks,absgrad",
    [(16, "exact", 2, 3, True, False), (16, "soft", 1, 4, False, True),
     (32, "exact", 1, 3, False, True), (32, "soft", 2, 4, True, False)],
)
def test_gradients_match_jax(rng, ts, cutoff, C, CH, use_masks, absgrad):
    args, ct, ca = _raster_case(rng, C, CH)
    kw = dict(tile_size=ts, isect_capacity=8192, cutoff_mode=cutoff)
    if use_masks:
        kw["masks"] = rng.random((C, -(-H // ts), -(-W // ts))) > 0.3
    got, meta = _port_grads(args, ct, ca, absgrad, **kw)
    ref = _jax_grads(args, ct, ca, absgrad, **kw)
    assert int(meta["n_isects"][0]) > 0
    for name, a, b in zip(NAMES, got, ref):
        assert_raster_grad_close(a, b, name)


def test_gradients_match_jax_under_truncation(rng):
    """A capacity below the total drops the deepest intersections; the
    gradients of the truncated runs are partial sums in both packages."""
    args, ct, ca = _raster_case(rng, 2, 3, N=1500)
    kw = dict(tile_size=16, isect_capacity=4096, cutoff_mode="exact")
    got, meta = _port_grads(args, ct, ca, True, **kw)
    ref = _jax_grads(args, ct, ca, True, **kw)
    _, _, _, cnt = tr.tile_counts(torch.as_tensor(args[0]),
                                  torch.as_tensor(args[5]), 16,
                                  -(-W // 16), -(-H // 16))
    assert int(cnt.sum()) > 4096 == int(meta["n_isects"][0])
    for name, a, b in zip(NAMES, got, ref):
        assert_raster_grad_close(a, b, name)


@pytest.mark.parametrize("C,CH", [(1, 3), (2, 4)])
def test_gradients_match_the_dense_oracle(rng, C, CH):
    """Exact cutoff, runs shorter than one chunk: the fused backward and
    autograd of the port's dense oracle compute the same function."""
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=C, N=120, W=48,
                                                   H=32, CH=CH)
    ct = torch.as_tensor(rng.standard_normal((C, 32, 48, CH)).astype(
        np.float32))
    grads = []
    for fn in ("fused", "oracle"):
        leaves = [torch.tensor(x, requires_grad=True)
                  for x in (m2, con, col, op, bg)]
        if fn == "fused":
            img, alp, _ = tr.rasterize_to_pixels_v2(
                *leaves[:4], dep, rad, 48, 32, backgrounds=leaves[4],
                isect_capacity=4096, device="cpu")
        else:
            img, alp = rasterize_to_pixels_ref(
                *leaves[:4], torch.as_tensor(dep), torch.as_tensor(rad), 48,
                32, backgrounds=leaves[4])
        ((img * ct).sum() + alp.sum()).backward()
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(NAMES, *grads):
        assert_grad_close(a, b.numpy(), 1e-4, name)


def test_unpack_and_segsum_plain_match_jax(rng):
    """B9b's and B4's plain versions against the JAX package's unpack_rows
    and segsum_rows on the same rows: the JAX reduction's id-sorted block
    with its 128-id block bounds, the port's rows with the count prefix."""
    d, M = 7, 300
    counts = rng.integers(0, 6, M).astype(np.int32)
    counts[::7] = 0
    cum = np.cumsum(counts).astype(np.int32)
    n = int(cum[-1])
    L = 4096
    vals = np.zeros((d, L), np.float32)
    vals[:, :n] = rng.standard_normal((d, n)).astype(np.float32)
    ids = np.full(L, jr.PAD_ID, np.float32)
    ids[:n] = np.repeat(np.arange(M), counts)
    block = np.concatenate([vals, ids[None]])  # the id row last

    ref = jr.unpack_rows(jnp.asarray(block), d + 1, interpret=True)
    got = tr.unpack_rows(torch.as_tensor(block), d + 1)
    np.testing.assert_array_equal(got.numpy(), np.stack(ref))
    perm = rng.permutation(L)  # scatter: column j goes to column perm[j]
    np.testing.assert_array_equal(
        tr.unpack_rows(torch.as_tensor(block), d, torch.as_tensor(perm)
                       ).numpy(), block[:d, np.argsort(perm)])

    nblk = -(-M // (128 * jr.SEG_G)) * jr.SEG_G
    idx = np.minimum(np.arange(1, nblk + 1) * 128 - 1, M - 1)
    bounds = np.concatenate([[0], np.minimum(cum[idx], n)]).astype(np.int32)
    seg_j = np.asarray(jr.segsum_rows(jnp.asarray(block), jnp.asarray(bounds),
                                      d, nblk, interpret=True))[:d, :M]
    seg_t = tr.segsum_rows(torch.as_tensor(vals), torch.as_tensor(cum),
                           torch.tensor([n], dtype=torch.int32)).numpy()
    scale = np.abs(seg_j).max()
    assert np.abs(seg_t - seg_j).max() <= 1e-6 * scale
    assert not seg_t[:, counts == 0].any()


def test_segsum_truncated_runs_keep_later_ids_aligned():
    cum = torch.tensor([3, 3, 7, 12, 15], dtype=torch.int32)
    rows = torch.arange(2 * 16, dtype=torch.float32).reshape(2, 16)
    cut = torch.tensor([9], dtype=torch.int32)
    got = tr.segsum_rows(rows, torch.clamp(cum, max=9), cut)
    want = torch.stack([rows[:, 0:3].sum(1), torch.zeros(2),
                        rows[:, 3:7].sum(1), rows[:, 7:9].sum(1),
                        torch.zeros(2)], 1)
    assert torch.equal(got, want)


def _render_leaves(rng, N=600):
    sc = make_test_scene(rng, C=2, N=N, width=W, height=H)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    # a dead slot (the trainer's opacity floor) and two behind the cameras
    sc["opacities"][:3] = 1.0 / (1.0 + np.exp(15.0))
    sc["means"][3:5] = [[0.0, 0.0, -6.0], [0.2, 0.1, -4.5]]
    return sc, sh


def test_rasterization_gradients_match_jax(rng):
    """Soft cutoff, the trainer's default; the raster tests above cover
    both cutoffs."""
    cutoff = "soft"
    sc, sh = _render_leaves(rng)
    names = ("means", "quats", "scales", "opacities")
    inputs = [sc[k] for k in names] + [sh]
    ct = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    kw = dict(sh_degree=3, isect_capacity=16384, cutoff_mode=cutoff)

    def jloss(means, quats, scales, opac, sh, probe):
        img, _, _ = jrasterization(
            means, quats, scales, opac, sh, jnp.asarray(sc["viewmats"]),
            jnp.asarray(sc["Ks"]), W, H, means2d_probe=probe, **kw)
        return jnp.sum(img * ct)

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, inputs), jnp.zeros((2, len(sh), 2), jnp.float32))

    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    probe = torch.zeros((2, len(sh), 2), requires_grad=True)
    img, _, _ = rasterization(*leaves, sc["viewmats"], sc["Ks"], W, H,
                              means2d_probe=probe, device="cpu", **kw)
    (img * torch.as_tensor(ct)).sum().backward()
    got = [t.grad for t in leaves] + [probe.grad]
    for name, a, b in zip(names + ("sh", "means2d_probe"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        assert_grad_close(a, b, 1e-3, name)
    # the dead and behind-camera slots get finite, zero gradients
    for a in got[:5]:
        assert not a[:5].any()
