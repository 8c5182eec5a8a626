"""B4's work counts and its partition (raster_v2.segsum_counts,
segsum_partition) against a count in numpy on a binned 2DGS scene with one
surfel whose AABB covers the whole screen, and B4's plain version against
the JAX package's segsum_rows (its Pallas kernel in interpret mode) on
ranges that the redesigned kernel splits: a range longer than the JAX
kernel's 512-column fetch (SEG_SC) at the edges of its 128-id blocks, runs
of empty ids between long ranges, and a truncation inside a long range.

Tolerances: the counts exactly; the sums within 1e-6 of the largest |sum|
(the same summands in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.ops import raster_v2 as jr
from gscodec_studio_tpu_torch.ops import raster_v2 as rv
from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as r2

TS, TW, TH = 8, 8, 6  # a 64 x 48 screen of 48 tiles


def _full_screen_scene(rng, N=60):
    """A binning of N small surfels and one (index 7) whose AABB covers the
    screen; returns (cum, n_isects)."""
    W, H = TS * TW, TS * TH
    means2d = np.stack([rng.random(N) * W, rng.random(N) * H], -1)
    radii = rng.integers(1, 12, (N, 2))
    means2d[7], radii[7] = (W / 2, H / 2), (W, H)
    s = 0.5
    trans = np.zeros((N, 9))
    trans[:, [0, 4, 8]] = s, s, 1.0
    trans[:, 2], trans[:, 5] = means2d[:, 0], means2d[:, 1]
    cfg = r2.cfg_2dgs(1, TW, TH, TS, 3, rv.CAP_BLOCK, N)
    b = r2._build_sorted_2dgs(
        cfg, torch.tensor(means2d[None], dtype=torch.float32),
        torch.tensor(trans[None], dtype=torch.float32),
        torch.rand((1, N, 3), generator=torch.Generator().manual_seed(0)),
        torch.full((1, N), 0.5), torch.tensor(rng.random((1, N)) + 1.0,
                                              dtype=torch.float32),
        torch.tensor(radii[None], dtype=torch.int32))
    return b.cum, b.n_isects


def _merged_blocks(e, items):
    """The merged sequence written out (each id's columns, then its end
    item), cut every ``items`` items: (ids ended, columns) at each cut."""
    seq = []
    for r, (lo, hi) in enumerate(zip(np.concatenate([[0], e[:-1]]), e)):
        seq += [("col", j) for j in range(lo, hi)] + [("end", r)]
    cuts = list(range(0, len(seq), items)) + [len(seq)]
    i = [sum(t == "end" for t, _ in seq[:k]) for k in cuts]
    return np.array(i), np.array(cuts) - np.array(i)


@pytest.mark.parametrize("cut", [None, 0.6])
def test_segsum_counts_match_numpy(rng, cut):
    cum, n_isects = _full_screen_scene(rng)
    total = int(cum[-1])
    assert int(n_isects) == total and int((torch.diff(
        cum, prepend=cum.new_zeros(1))).max()) == TW * TH
    if cut is not None:  # a truncation inside the full-screen range
        n_isects = torch.tensor([int(cut * total)], dtype=torch.int32)
    n = int(n_isects)
    d, items = 19, 32  # the 48-tile range spans warps
    e = np.minimum(cum.numpy().astype(np.int64), n)
    lens = np.diff(e, prepend=0)
    live = np.sort(lens[lens > 0])
    walk = -(-lens // 4)
    walk = np.concatenate([walk, np.zeros(-len(walk) % 8, np.int64)])
    i_ref, j_ref = _merged_blocks(e, items)
    cols = np.diff(j_ref)

    i, j = rv.segsum_partition(cum, n_isects, items)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_array_equal(j.numpy(), j_ref)
    got = rv.segsum_counts(cum, n_isects, d, items)
    want = dict(
        ids=len(lens), live_ids=len(live), intersections=n, rows=d,
        max_range=int(live[-1]),
        p99_range=int(live[int(np.ceil(0.99 * len(live))) - 1]),
        mean_range=float(live.mean()),
        ids_over_warp=int((lens > items).sum()),
        parent_warp_loads=int(walk.reshape(-1, 8).max(1).max()) * d,
        warp_items=items, warps=len(cols),
        max_warp_columns=int(cols.max()),
        max_warp_loads=int(cols.max()) * d,
        max_lane_loads=rv.SEG_LANE_COLUMNS * d)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    # the full-screen surfel's range: longer than a warp's items, walked by
    # one warp's 4 lanes before and by SEG_LANE_COLUMNS words a lane now
    assert want["ids_over_warp"] >= 1
    assert got["parent_warp_loads"] >= -(-min(TW * TH, n) // 4) * d


def _jax_segsum(vals, cum, n):
    """The JAX reduction's segsum_rows on ``vals`` (f32 [d, L], expansion
    order) with its id row and 128-id block bounds, as _reduce_grads
    builds them."""
    d, L = vals.shape
    M = cum.shape[0]
    e = np.minimum(cum, n)
    ids = np.full(L, jr.PAD_ID, np.float32)
    ids[:e[-1]] = np.repeat(np.arange(M), np.diff(e, prepend=0))
    block = np.concatenate([vals, ids[None]])
    nblk = -(-M // (128 * jr.SEG_G)) * jr.SEG_G
    idx = np.minimum(np.arange(1, nblk + 1) * 128 - 1, M - 1)
    bounds = np.concatenate([[0], np.minimum(cum[idx], n)]).astype(np.int32)
    return np.asarray(jr.segsum_rows(jnp.asarray(block), jnp.asarray(bounds),
                                     d, nblk, interpret=True))[:d, :M]


@pytest.mark.parametrize("truncate", [False, True])
def test_segsum_plain_matches_jax_on_long_ranges(rng, truncate):
    d, M = 3, 300
    counts = rng.integers(0, 5, M)
    # long ranges at the edges of the JAX kernel's 128-id blocks, with runs
    # of empty ids between them
    counts[126], counts[127], counts[128] = 700, 530, 900
    counts[129:134] = 0
    counts[134] = 650
    counts[255:258] = 0, 1200, 0
    cum = np.cumsum(counts).astype(np.int32)
    total = int(cum[-1])
    assert counts.max() > jr.SEG_SC
    # a truncation inside id 128's range
    n = int(cum[127]) + 333 if truncate else total
    L = -(-total // 512) * 512
    vals = np.zeros((d, L), np.float32)
    vals[:, :n] = rng.standard_normal((d, n)).astype(np.float32)
    seg_j = _jax_segsum(vals, cum, n)
    seg_t = rv.segsum_rows(torch.as_tensor(vals), torch.as_tensor(cum),
                           torch.tensor([n], dtype=torch.int32)).numpy()
    scale = np.abs(seg_j).max()
    assert np.abs(seg_t - seg_j).max() <= 1e-6 * scale
    empty = np.diff(np.minimum(cum, n), prepend=0) == 0
    assert not seg_t[:, empty].any() and not seg_j[:, empty].any()
    if truncate:
        assert empty[129:].all() and not empty[128]
