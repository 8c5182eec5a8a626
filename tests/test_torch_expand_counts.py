"""raster_v2.expand_counts (B3's work in its block layout, csrc/expand.cu)
against a row-by-row count written out here, on small seeded 3DGS
binnings (tiles 16 and 32), one with invisible Gaussians (which the
expansion never reads), one with a Gaussian whose run spans several
blocks, one whose counts overflow the capacity (n_isects == cap), one with
nothing visible (n_isects == 0), and a prefix with zero counts inside a
block's window. Counts are integers: exact equality.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as tr


def _binning(seed, ts, cap, big=False, visible=True, hidden=0, C=1, N=400,
             W=160, H=120):
    rng = np.random.default_rng(seed)
    m2 = np.stack([rng.random((C, N)) * W, rng.random((C, N)) * H],
                  -1).astype(np.float32)
    radii = rng.integers(1, 20, (C, N, 2)).astype(np.int32)
    if big:  # one Gaussian over most of the image
        m2[0, 0] = (W / 2, H / 2)
        radii[0, 0] = (W // 2, H // 2)
    if not visible:
        radii[:] = 0
    radii[:, :hidden] = 0
    con = np.tile(np.float32([0.5, 0.0, 0.5]), (C, N, 1))
    col = rng.random((C, N, 3)).astype(np.float32)
    op = rng.random((C, N)).astype(np.float32)
    dep = (1.0 + rng.random((C, N))).astype(np.float32)
    t = [torch.as_tensor(a) for a in (m2, con, col, op, dep)]
    cfg = tr.V2Cfg(C=C, tile_width=-(-W // ts), tile_height=-(-H // ts),
                   tile_size=ts, channels=3, cap=cap, n=N)
    order, cum, base, nx, n_isects = tr._compact(cfg, t[0],
                                                 torch.as_tensor(radii), t[4])
    table = tr.pack_rows(tr._attr_rows(cfg, *t[:4]), cfg.n_attr_eff, order)
    tile, _ = tr.expand(cum, base, nx, table, n_isects, cfg)
    return cfg, cum, n_isects, tile


def _by_rows(cum, n, cap, rpb, n_tiles, tile):
    """The counts by walking the rows one at a time."""
    cum = [int(c) for c in cum]
    g, gs = 0, []
    for p in range(n):
        while g < len(cum) - 1 and cum[g] <= p:
            g += 1
        gs.append(g)
    windows, read = [], set()
    for p0 in range(0, n, rpb):
        in_block = gs[p0:min(p0 + rpb, n)]
        windows.append(max(in_block) - min(in_block) + 1)
        read.update(range(min(in_block), max(in_block) + 1))
    runs, prev = [], 0
    for c in cum:
        runs.append(c - prev)
        prev = c
    blocks = -(-cap // rpb)
    return dict(rows=n, tail_rows=cap - n, gaussians=len(read), blocks=blocks,
                live_blocks=len(windows), tail_blocks=blocks - len(windows),
                window_max=max(windows, default=0),
                window_mean=float(np.mean(windows)) if windows else 0.0,
                wide=sum(w > rpb for w in windows), longest_run=max(runs),
                culled=sum(int(tile[p]) == n_tiles for p in range(n)))


def _check(cfg, cum, n_isects, tile, rpb):
    got = tr.expand_counts(cum, n_isects, cfg, rpb, tile=tile)
    want = _by_rows(cum, int(n_isects[0]), cfg.cap, rpb, cfg.n_tiles, tile)
    for key in ("rows", "tail_rows", "gaussians", "blocks", "live_blocks",
                "tail_blocks", "longest_run", "culled"):
        assert got[key] == want[key], key
    assert got["window"]["max"] == want["window_max"]
    assert got["window"]["mean"] == pytest.approx(want["window_mean"])
    assert got["wide_windows"] == want["wide"]
    assert got["rows_per_block"] == rpb
    return got


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("rpb", [64, 512])
def test_expand_counts_match_row_walk(ts, rpb):
    cfg, cum, n, tile = _binning(1, ts, 1 << 14)
    got = _check(cfg, cum, n, tile, rpb)
    assert 0 < got["rows"] < cfg.cap and got["culled"] > 0


@pytest.mark.parametrize("rpb", [64, 512])
def test_expand_counts_leave_the_invisible_unread(rpb):
    # the Gaussians B3 reads (its bytes bound's) are the visible ones only
    cfg, cum, n, tile = _binning(5, 16, 1 << 14, hidden=150)
    got = _check(cfg, cum, n, tile, rpb)
    assert got["gaussians"] == 250 == int((torch.diff(
        cum, prepend=cum.new_zeros(1)) > 0).sum())


def test_expand_counts_run_over_blocks():
    cfg, cum, n, tile = _binning(2, 16, 1 << 14, big=True)
    got = _check(cfg, cum, n, tile, 16)
    assert got["longest_run"] == 80  # one Gaussian over 5 blocks' rows
    assert got["window"]["max"] <= 16 and got["wide_windows"] == 0


def test_expand_counts_overflow_and_empty():
    cfg, cum, n, tile = _binning(3, 16, 700)
    assert int(n[0]) == cfg.cap and int(cum[-1]) == cfg.cap
    got = _check(cfg, cum, n, tile, 64)
    assert got["tail_rows"] == 0 and got["tail_blocks"] == 0
    cfg, cum, n, tile = _binning(4, 16, 1000, visible=False)
    got = _check(cfg, cum, n, tile, 64)
    assert got["rows"] == 0 and got["live_blocks"] == 0
    assert got["gaussians"] == 0
    assert got["window"]["max"] == 0 and got["culled"] == 0


def test_expand_counts_zero_counts_in_a_window():
    # counts 0 inside a block's window, which the binning never makes:
    # the window is then wider than the block
    cum = torch.tensor(np.cumsum([3, 0, 0, 0, 0, 0, 2, 1, 0, 0, 4]),
                       dtype=torch.int32)
    n = torch.tensor([10], dtype=torch.int32)
    cfg = tr.V2Cfg(C=1, tile_width=4, tile_height=4, tile_size=16,
                   channels=3, cap=13, n=11)
    tile = torch.zeros(13, dtype=torch.int32)
    got = _check(cfg, cum, n, tile, 4)
    assert got["wide_windows"] == 2 and got["window"]["max"] == 7
