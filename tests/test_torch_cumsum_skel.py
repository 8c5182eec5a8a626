"""The last two TPU kernels' plain versions on the CPU: B10's cumsum_rows
(ops/raster_v2.py) against the JAX package's cumsum_rows in interpret
mode, and B11's skeleton composite (profiling/kernel_skel_bench.py)
against a numpy restatement of the JAX script's kernel.

Tolerances:
  * cumsum_rows: each entry within gamma(D + 1) sum|x| of the JAX one, the
    sum over its prefix, gamma(k) = k u / (1 - k u) with u = 2^-24. The
    JAX kernel adds in float32 by a log-step scan of each 8192-column
    block (13 roundings on a term's path) and one carry add per block
    before it, plus one: D = 13 + L / 8192 + 1. torch.cumsum on the CPU
    accumulates in float64 and rounds once, the last u. Checked on signed
    and on non-negative rows (where the bound is a few ulps of each
    value);
  * the skeleton: max abs 1e-5 (the transmittance products and colour
    sums in another order).

B10's own order of additions (csrc/cumsum_rows.cu), restated in float32
(_b10_order): within raster_v2.cumsum_rows_bound of a float64 cumsum, on
signed and non-negative rows that span several segments and groups.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu.ops.raster_v2 import cumsum_rows as jcumsum_rows
from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.profiling import kernel_skel_bench as skel

F32_UNIT = 2.0 ** -24


@pytest.mark.parametrize("draw", ["standard_normal", "random"])
def test_cumsum_rows_matches_jax(rng, draw):
    x = getattr(rng, draw)((9, 3 * 8192)).astype(np.float32)
    ref = np.asarray(jcumsum_rows(x, interpret=True))
    tr.reset_launch_counts()
    got = tr.cumsum_rows(torch.as_tensor(x)).numpy()
    assert tr.LAUNCHES["cumsum_rows"] == 0  # the CPU runs the plain one
    blk = 8192  # gscodec_studio_tpu/ops/raster_v2.py CUMSUM_BLK
    du = (int(np.log2(blk)) + x.shape[1] // blk + 2) * F32_UNIT
    bound = du / (1 - du) * np.cumsum(np.abs(x).astype(np.float64), 1)
    assert got.shape == ref.shape
    assert (np.abs(got.astype(np.float64) - ref) <= bound).all()


def _scan_lanes(v):
    """Inclusive Hillis-Steele scan over the last axis (32 lanes), in
    float32: at offset o each lane adds the lane o before it."""
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], -1)
    return v


def _left_lane(v):
    """The exclusive value of a lane scan: the left lane's, 0 at lane 0."""
    return torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)


def _scan_in_order(v):
    """Inclusive scan of the last axis one add at a time, in float32."""
    out = [v[..., 0]]
    for j in range(1, v.shape[-1]):
        out.append(out[-1] + v[..., j])
    return torch.stack(out, -1)


def _b10_order(x):
    """csrc/cumsum_rows.cu's sums, restated in float32 torch: a segment of
    SEG elements is [CHUNKS, warps, 32 lanes, 4 values] in position order;
    each lane's 4 values scanned in order; each chunk's lane totals by a
    lane scan; the 32 (chunk, warp) pieces by a lane scan, whose last is
    the segment's total A; a row's segments in groups of GROUP, A four a
    lane scanned in order, then across the lanes (W: the group's exclusive
    prefix, T: its total); the groups' prefixes chained, Q_{q+1} = Q_q +
    T_q; y = ((((Q + W) + piece prefix) + lane prefix) + value's
    prefix)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    R, L = x.shape
    threads, chunks, group = tr.CUMSUM_THREADS, tr.CUMSUM_CHUNKS, \
        tr.CUMSUM_GROUP
    n_seg, n_grp = tr._cumsum_layout(L)
    xp = torch.zeros((R, n_seg * tr.CUMSUM_SEG), dtype=torch.float32)
    xp[:, :L] = x
    s = _scan_in_order(xp.reshape(R, n_seg, chunks, threads // 32, 32, 4))
    om = _scan_lanes(s[..., 3])
    pieces = _scan_lanes(om[..., 31].reshape(R, n_seg, 32))
    agg = torch.zeros((R, n_grp * group), dtype=torch.float32)
    agg[:, :n_seg] = pieces[..., 31]
    b = _scan_in_order(agg.reshape(R, n_grp, 32, 4))
    lam = _scan_lanes(b[..., 3])
    within = torch.cat([torch.zeros_like(b[..., :1]), b[..., :3]], -1)
    w = (_left_lane(lam)[..., None] + within).reshape(R, n_grp * group)
    q = [torch.zeros(R, dtype=torch.float32)]
    for i in range(n_grp - 1):
        q.append(q[-1] + lam[:, i, 31])
    q = torch.stack(q, 1)
    e = q.repeat_interleave(group, 1)[:, :n_seg] + w[:, :n_seg]
    base = (e[..., None] + _left_lane(pieces)).reshape(
        R, n_seg, chunks, threads // 32)
    o = base[..., None] + _left_lane(om)
    return (o[..., None] + s).reshape(R, -1)[:, :L]


@pytest.mark.parametrize("draw", ["standard_normal", "random"])
def test_cumsum_rows_kernel_order_within_bound(rng, draw):
    seg, grp = tr.CUMSUM_SEG, tr.CUMSUM_GROUP * tr.CUMSUM_SEG
    for R, L in ((3, 1), (2, seg - 1), (2, seg + 1), (1, grp - 1),
                 (2, 3 * grp + 4097)):
        x = getattr(rng, draw)((R, L)).astype(np.float32)
        got = _b10_order(x)
        ref = torch.cumsum(torch.as_tensor(x).double(), 1)
        bound = tr.cumsum_rows_bound(torch.as_tensor(x))
        assert bool(((got.double() - ref).abs() <= bound).all()), (R, L)
    # the restatement is the scan it says: its first segment's first chunk
    # is a plain in-order cumsum over the first 4 values of a lane
    assert got[0, 3] == ((x[0, 0] + x[0, 1]) + x[0, 2]) + x[0, 3]


def _skel_numpy(rows, starts, ends):
    """profiling/kernel_skel_bench.py:65-122, restated with numpy: per
    tile, the 128-column windows from start // 128 to ceil(end / 128)
    while some pixel has T > 1e-4; pixels at (p % 16, p // 16); columns
    outside [start, end) masked; the soft composite with an exclusive
    cumulative product along the columns; out [T, 256, 3]."""
    K, P = 128, 256
    p = np.arange(P)[:, None]
    px, py = (p % 16).astype(np.float32), (p // 16).astype(np.float32)
    out = np.zeros((len(starts), P, 3), np.float32)
    for t, (off, end) in enumerate(zip(starts, ends)):
        t_scr = np.ones((P, 1), np.float32)
        c, c1 = off // K, (end + K - 1) // K
        while c < c1 and t_scr.max() > 1e-4:
            chunk = rows[:, c * K:(c + 1) * K]
            xs, ys, ca, cb, cc, op = (chunk[i:i + 1] for i in range(6))
            dx, dy = xs - px, ys - py
            sigma = (np.float32(0.5) * ca) * (dx * dx) \
                + (np.float32(0.5) * cc) * (dy * dy) + cb * (dx * dy)
            idx = c * K + np.arange(K)[None]
            inr = (idx >= off) & (idx < end)
            with np.errstate(over="ignore"):  # exp(-sigma) for sigma < 0
                alpha = np.minimum(np.float32(0.999), op * np.exp(-sigma))
            valid = (sigma >= 0) & (alpha >= np.float32(1 / 255)) & inr
            alpha = np.where(valid, alpha, np.float32(0))
            oma = 1 - alpha
            excl = np.cumprod(np.concatenate(
                [np.ones((P, 1), np.float32), oma[:, :-1]], 1), 1)
            t_prev = excl * t_scr
            w = alpha * t_prev
            t_scr = t_prev[:, K - 1:K] * oma[:, K - 1:K]
            out[t] += w @ chunk[6:9].T
            c += 1
    return out


@pytest.mark.parametrize("term", [None, 24.0])
def test_skel_plain_matches_numpy_restatement(term):
    rows, starts, ends, cap = skel.make(12, 300, term, seed=3)
    ref = _skel_numpy(rows, starts, ends)
    tr.reset_launch_counts()
    got, counts = skel._skel_plain(*map(torch.as_tensor,
                                        (rows, starts, ends)),
                                   with_counts=True)
    assert tr.LAUNCHES["skel_composite"] == 0
    assert counts["composited"] > 1000
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    out = skel.skel_composite(*map(torch.as_tensor, (rows, starts, ends)))
    np.testing.assert_array_equal(out.numpy(), got.numpy())
