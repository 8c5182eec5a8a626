"""The packed-pair gradient rows (grad_dtype="bf16") of
gscodec_studio_tpu_torch's fused rasterizer against the JAX package, whose
Pallas kernels run in interpret mode on the CPU, on the same numpy inputs.

Tolerances:
  * pack_pairs and unpack_pairs: bit for bit against the JAX package's
    _pack_pair and _unpack_pair, on values that include +-0, subnormals,
    infinities and exact rounding ties (where truncation and rounding to
    nearest even give other bits);
  * the plain versions of the packed branches: the packed tile backward
    bit for bit against the f32 rows truncated; the packed segment sums
    within 1e-6 of each row's largest |sum| of the truncated halves
    (another summation order); the unpack moves the words bit for bit, also
    with denormals flushed;
  * rasterize_to_pixels_v2(grad_dtype="bf16") against JAX: every entry
    within 2^-6 of its tensor's largest |value| and at least 98% of the
    entries bit-equal. Both packages truncate f32 sums of the same
    truncated terms, summed in another order; where the f32 sums differ by
    an ulp across a truncation boundary, the results differ by one bf16
    step (2^-7 relative to the value);
  * the port's bf16 gradients against its own f32 ones: within 1.5e-2 of
    each tensor's largest |value|, the tolerance of the JAX package's own
    test (tests/test_raster_v2.py:46).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops import raster_v2 as jr
from gscodec_studio_tpu_torch.ops import raster_v2 as tr

from tests.test_torch_raster_v2_bwd import (NAMES, W, H, _jax_grads,
                                            _port_grads, _raster_case)


def _edge_values(rng, n):
    special = np.array(
        [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, np.inf, -np.inf, 1.0, -2.5,
         3.4e38], np.float32)
    # exact ties: the low 16 bits are 0x8000, halfway between two bf16s
    ties = (rng.integers(0x3F000000, 0x40800000, n, dtype=np.uint32)
            & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    rand = rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.uniform(
        -30, 30, n).astype(np.float32)
    return np.concatenate([special, ties.view(np.float32), rand])


def test_pack_pairs_bit_equal_to_jax(rng):
    a = _edge_values(rng, 200)
    b = rng.permutation(_edge_values(rng, 200))
    got = tr.pack_pairs(torch.as_tensor(a), torch.as_tensor(b))
    ref = jax.lax.bitcast_convert_type(
        jr._pack_pair(jnp.asarray(a), jnp.asarray(b)), jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    hi, lo = tr.unpack_pairs(got)
    jhi, jlo = jr._unpack_pair(jax.lax.bitcast_convert_type(ref, jnp.float32))
    for x, y in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(
            x.view(torch.int32).numpy(),
            np.asarray(jax.lax.bitcast_convert_type(y, jnp.int32)))
    # truncation, not rounding: on the ties rounding moves the high half
    rounded = torch.as_tensor(a).to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(rounded.view(torch.int32), hi.view(torch.int32))


def test_packed_plain_versions(rng):
    args, ct, ca = _raster_case(rng, 1, 3)
    m2, con, col, op, dep, radii, _ = (torch.as_tensor(x) for x in args)
    cfg = tr.V2Cfg(C=1, tile_width=-(-W // 16), tile_height=-(-H // 16),
                   tile_size=16, channels=3, cap=8192, n=m2.shape[1])
    b = tr._build_sorted(cfg, m2, con, col, op, dep, radii)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32)
    tiles = tr.raster_fwd(b.S, b.starts, masks, cfg)
    v_tiles = torch.as_tensor(
        rng.standard_normal(tiles.shape).astype(np.float32))
    for absgrad in (False, True):
        args_b = (b.S, b.starts, masks, tiles, v_tiles, cfg, absgrad)
        f32 = tr.raster_bwd(*args_b)
        packed = tr.raster_bwd(*args_b, packed=True)
        assert packed.dtype == torch.int32
        assert packed.shape == (cfg.d_gp(absgrad), cfg.cap)
        assert cfg.d_gp(absgrad) == 5 + absgrad  # 9 values -> 5 pairs
        hi, lo = tr.unpack_pairs(packed)
        vals = torch.stack([hi, lo], 1).reshape(-1, cfg.cap)
        want = f32.view(torch.int32) & -65536
        if absgrad:  # (0, 1) ... (8, 0), (|x|, |y|)
            vals = torch.cat([vals[:9], vals[10:12]])
        else:
            vals = vals[:9]
        np.testing.assert_array_equal(vals.view(torch.int32).numpy(),
                                      want.numpy())
    # the segment sums of the halves
    rows = tr.unpack_rows(packed, packed.shape[0], b.perm)
    seg = tr.segsum_rows(rows, b.cum, b.n_isects)
    assert seg.shape == (2 * packed.shape[0], cfg.C * cfg.n)
    hi, lo = tr.unpack_pairs(rows)
    n = int(b.n_isects)
    ids = tr.segment_ids(b.cum, b.n_isects).numpy()
    halves = torch.cat([hi, lo])[:, :n].double().numpy()
    ref = np.zeros(seg.shape)
    for r in range(ref.shape[0]):
        ref[r] = np.bincount(ids, halves[r], minlength=ref.shape[1])
    scale = np.abs(ref).max(axis=1, keepdims=True).clip(1e-30)
    assert (np.abs(seg.numpy() - ref) / scale).max() <= 1e-6


def test_unpack_moves_packed_words_bit_for_bit(rng):
    # high half 0, low half not: each word reads as a subnormal float
    words = torch.as_tensor(rng.integers(1, 1 << 16, (3, 500),
                                         dtype=np.int32))
    perm = torch.as_tensor(rng.permutation(500))
    ok = torch.set_flush_denormal(True)
    try:
        out = tr.unpack_rows(words, 3, perm)
        back = tr.unpack_rows(words.view(torch.float32), 3, perm)
    finally:
        torch.set_flush_denormal(False)
    want = torch.empty_like(words)
    want[:, perm] = words
    assert torch.equal(out, want)
    assert torch.equal(back.view(torch.int32), want), ok


@pytest.mark.parametrize(
    "ts,cutoff,C,CH,absgrad",
    [(16, "exact", 2, 3, False), (16, "soft", 1, 4, True),
     (32, "exact", 1, 3, True)])
def test_bf16_gradients_match_jax(rng, ts, cutoff, C, CH, absgrad):
    args, ct, ca = _raster_case(rng, C, CH)
    kw = dict(tile_size=ts, isect_capacity=8192, cutoff_mode=cutoff,
              grad_dtype="bf16")
    got, meta = _port_grads(args, ct, ca, absgrad, **kw)
    ref = _jax_grads(args, ct, ca, absgrad, **kw)
    assert int(meta["n_isects"][0]) > 0
    f32, _ = _port_grads(args, ct, ca, absgrad,
                         **dict(kw, grad_dtype="f32"))
    for name, a, b, c in zip(NAMES, got, ref, f32):
        a, b, c = a.detach().numpy(), np.asarray(b), c.detach().numpy()
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= 2.0 ** -6 * scale, name
        assert np.abs(a - c).max() <= 1.5e-2 * np.abs(c).max(), name
        if name != "backgrounds":  # not a packed row: f32 in both
            assert np.mean(a == b) >= 0.98, (name, np.mean(a == b))
            # every value is a truncated bf16
            bits = a.view(np.int32)
            assert not (bits & 0xFFFF).any(), name
