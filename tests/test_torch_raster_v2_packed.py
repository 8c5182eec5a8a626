"""The sorted table's precision knobs of gscodec_studio_tpu_torch's fused
rasterizer (attr_dtype="bf16", geom_dtype="u16", log_composite) against the
JAX package, whose Pallas kernels run in interpret mode on the CPU, on the
same numpy inputs.

Tolerances:
  * pack_u16_xy and unpack_u16_xy: bit for bit against the JAX package's
    _pack_u16_xy and _unpack_u16_xy, on centres clipped at +-4096 px, on
    halfway values x.0625 (the quantizer's +0.5 lands on an integer) and
    on words whose qx >= 32768 (negative int32);
  * the sorted table S and starts: bit for bit, the packed rows word for
    word, for each knob; with denormals flushed the packed words still
    reach the tile kernels' plain versions with their bits;
  * images and alphas: tests/test_torch_raster_v2.py's, max abs <= 5e-3
    and >= 99.9% of the values within 1e-4. The log scan sums its terms
    pair by pair here and by a matmul in JAX, so T differs in the last
    bits;
  * gradients, relative to each reference tensor's largest |value|: with
    f32 rows, tests/test_torch_raster_v2_bwd.py's (>= 99% within 1e-4, all
    within 5e-3); with bf16 gradient rows,
    tests/test_torch_raster_v2_bf16.py's (all within 2^-6). Each case
    prints its measured maxima (pytest -s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import raster_v2 as jr
from gscodec_studio_tpu_torch.ops import raster_v2 as tr

from tests.test_rasterize_pallas import make_2d_scene
from tests.test_torch_raster_v2 import assert_images_close
from tests.test_torch_raster_v2_bwd import (NAMES, _elliptical,
                                            assert_raster_grad_close)

# small enough that the JAX side's interpret-mode kernels stay quick
W, H = 64, 48

KNOBS = {
    "attr_bf16": dict(attr_dtype="bf16"),
    "geom_u16": dict(geom_dtype="u16"),
    "log": dict(log_composite=True),
    # bench.py's packed configuration, with the u16 positions as well
    "all_bf16_grads": dict(attr_dtype="bf16", geom_dtype="u16",
                           log_composite=True, grad_dtype="bf16"),
}


def test_u16_xy_bits_match_jax(rng):
    halves = (rng.integers(-32760, 32760, 200) + 0.5) / 8.0  # x.0625 etc.
    x = np.concatenate([
        [-5000.0, -4096.0, -4096.0625, -4095.9375, 4095.875, 4095.9375,
         4096.0, 1e9, -1e9, 0.0, -0.0, -16.0, 0.0625, 4095.0625],
        halves, rng.uniform(0.0, 4100.0, 200),  # qx >= 32768
        rng.uniform(-4200.0, 4200.0, 200)]).astype(np.float32)
    y = rng.permutation(x)
    got = tr.pack_u16_xy(torch.as_tensor(x), torch.as_tensor(y))
    ref = jax.lax.bitcast_convert_type(
        jr._pack_u16_xy(jnp.asarray(x), jnp.asarray(y)), jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() < 0).sum() > 100  # qx >= 32768 reads negative
    gx, gy = tr.unpack_u16_xy(got)
    jx, jy = jr._unpack_u16_xy(jax.lax.bitcast_convert_type(ref, jnp.float32))
    for a, b in ((gx, jx), (gy, jy)):
        np.testing.assert_array_equal(a.view(torch.int32).numpy(),
                                      np.asarray(b).view(np.int32))
    # clipped to the edges, not refused
    assert float(gx.min()) == -4096.0 and float(gx.max()) == 4095.875


def _raster_case(rng, C, CH, N=300):
    m2, con, col, op, dep, rad, bg = make_2d_scene(rng, C=C, N=N, W=W, H=H,
                                                   CH=CH)
    ct = rng.standard_normal((C, H, W, CH)).astype(np.float32)
    ca = rng.standard_normal((C, H, W, 1)).astype(np.float32)
    return (m2, con, col, op, dep, _elliptical(rng, rad), bg), ct, ca


def _cfgs(args, ts, knobs):
    m2 = args[0]
    geo = dict(C=m2.shape[0], tile_width=-(-W // ts),
               tile_height=-(-H // ts), tile_size=ts,
               channels=args[2].shape[-1], cap=8192, n=m2.shape[1])
    kn = {k: v for k, v in knobs.items() if k != "grad_dtype"}
    jcfg = jr.V2Cfg(**geo, tiles_per_step=1, interpret=True, absgrad=False,
                    **kn)
    return tr.V2Cfg(**geo, **kn), jcfg


@pytest.mark.parametrize("name", ["attr_bf16", "geom_u16", "all_bf16_grads"])
def test_sorted_table_words_match_jax(rng, name):
    args, _, _ = _raster_case(rng, 2, 3)
    m2, con, col, op, dep, radii, _ = args
    cfg, jcfg = _cfgs(args, 16, KNOBS[name])
    S, starts, _ = jr._build_sorted(
        jcfg, *map(jnp.asarray, (m2, con, col, op, dep, radii)))
    b = tr._build_sorted(cfg, *map(torch.as_tensor,
                                   (m2, con, col, op, dep, radii)))
    assert b.S.shape == (cfg.d_s, cfg.cap)
    assert cfg.idrow == jcfg.idrow and cfg.n_srows == jcfg.n_srows
    n = int(b.n_isects)
    assert n > 0
    np.testing.assert_array_equal(b.S.view(torch.int32).numpy()[:, :n],
                                  np.asarray(S).view(np.int32)[:cfg.d_s, :n])
    np.testing.assert_array_equal(b.starts.numpy(), np.asarray(starts))
    # the same words with denormals flushed: only copies and integer
    # operations touch the packed rows, and the plain readers unpack them
    # alike
    ok = torch.set_flush_denormal(True)
    try:
        b2 = tr._build_sorted(cfg, *map(torch.as_tensor,
                                        (m2, con, col, op, dep, radii)))
        chunk = b2.S[:, :n]
        vals = tr._chunk_values(cfg, chunk)
    finally:
        torch.set_flush_denormal(False)
    assert torch.equal(b2.S.view(torch.int32), b.S.view(torch.int32)), ok
    ref = tr._chunk_values(cfg, b.S[:, :n])
    for a, c in zip(vals[0] + [vals[1]], ref[0] + [ref[1]]):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


def test_layout_rows():
    """The rows before the id move with the knobs (CH = 3): 9 in f32, 8
    with u16 positions, 6 with bf16 pairs, 5 with both."""
    geo = dict(C=1, tile_width=2, tile_height=2, tile_size=16, channels=3,
               cap=4096, n=10)
    want = {("f32", "f32"): 9, ("f32", "u16"): 8, ("bf16", "f32"): 6,
            ("bf16", "u16"): 5}
    for (a, g), n in want.items():
        cfg = tr.V2Cfg(**geo, attr_dtype=a, geom_dtype=g)
        assert cfg.n_srows == cfg.idrow == n and cfg.d_s == n + 1
    # the 2DGS layout takes neither packing
    cfg = tr.V2Cfg(**geo, n_attr=19, cull=False, attr_dtype="bf16",
                   geom_dtype="u16")
    assert not (cfg.attr_packed or cfg.geom_packed) and cfg.n_srows == 19


def _port_fwd_grads(args, ct, ca, **kw):
    m2, con, col, op, dep, radii, bg = args
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (m2, con, col, op, bg)]
    img, alp, meta = tr.rasterize_to_pixels_v2(
        *leaves[:4], dep, radii, W, H, backgrounds=leaves[4], device="cpu",
        **kw)
    ((img * torch.as_tensor(ct)).sum()
     + (alp * torch.as_tensor(ca)).sum()).backward()
    return img.detach(), alp.detach(), [t.grad for t in leaves], meta


def _jax_fwd_grads(args, ct, ca, **kw):
    m2, con, col, op, dep, radii, bg = args

    def loss(m2, con, col, op, bg):
        img, alp, _ = jr.rasterize_to_pixels_v2(
            m2, con, col, op, jnp.asarray(dep), jnp.asarray(radii), W, H,
            backgrounds=bg, tiles_per_step=1, **kw)
        return jnp.sum(img * ct) + jnp.sum(alp * ca), (img, alp)

    (_, (img, alp)), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True))(
            *map(jnp.asarray, (m2, con, col, op, bg)))
    return img, alp, g


def check_images_and_gradients(rng, name, ts, cutoff):
    """Images, alphas and gradients of one knob setting against JAX."""
    args, ct, ca = _raster_case(rng, 1, 3)
    kw = dict(tile_size=ts, isect_capacity=8192, cutoff_mode=cutoff,
              **KNOBS[name])
    img, alp, got, meta = _port_fwd_grads(args, ct, ca, **kw)
    rimg, ralp, ref = _jax_fwd_grads(args, ct, ca, **kw)
    assert int(meta["n_isects"][0]) > 0
    assert float(alp.mean()) > 0.05
    # the measured maxima, printed for the record (pytest -s)
    gerr = {n: float(np.abs(a.detach().numpy() - np.asarray(b)).max()
                     / np.abs(np.asarray(b)).max())
            for n, a, b in zip(NAMES, got, ref)}
    print(f"{name} tile {ts} {cutoff}: image max abs "
          f"{float(np.abs(img.numpy() - np.asarray(rimg)).max()):.3g}, "
          f"alpha {float(np.abs(alp.numpy() - np.asarray(ralp)).max()):.3g}"
          f", gradients / scale {max(gerr.values()):.3g}")
    assert_images_close(img, rimg)
    assert_images_close(alp, ralp)
    for gname, a, b in zip(NAMES, got, ref):
        if kw.get("grad_dtype") == "bf16":
            a, b = a.detach().numpy(), np.asarray(b)
            scale = np.abs(b).max()
            assert scale > 0, gname
            assert np.abs(a - b).max() <= 2.0 ** -6 * scale, gname
        else:
            assert_raster_grad_close(a, b, gname)


# the log scan's cases are in test_torch_raster_v2_log.py
@pytest.mark.parametrize("name,ts,cutoff", [
    ("attr_bf16", 16, "exact"), ("attr_bf16", 32, "soft"),
    ("geom_u16", 16, "soft"), ("geom_u16", 32, "exact"),
])
def test_images_and_gradients_match_jax(rng, name, ts, cutoff):
    check_images_and_gradients(rng, name, ts, cutoff)


def test_unknown_knob_values_raise():
    args = [torch.zeros((1, 4, 2)), torch.zeros((1, 4, 3)),
            torch.zeros((1, 4, 3)), torch.zeros((1, 4)), torch.ones((1, 4)),
            torch.zeros((1, 4), dtype=torch.int32)]
    for kw, what in ((dict(attr_dtype="f16"), "attr_dtype"),
                     (dict(geom_dtype="u8"), "geom_dtype")):
        with pytest.raises(ValueError, match=what):
            tr.rasterize_to_pixels_v2(*args, 32, 32, device="cpu", **kw)
