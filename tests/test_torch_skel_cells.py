"""B11's cell test on the CPU: kernel_skel_bench._cell_bits, the mirror of
csrc/skel_composite.cu's cell_bits, and the counts of the kernel's work
that kernel_skel_bench._skel_plain(..., with_counts=True) takes with it.

  * The test keeps every slot that the plain version composites
    ("missed" 0) on the first tiles of each of the JAX script's four
    inputs, on constructed pairs (indefinite, negative-definite,
    near-singular and degenerate conics; centres on pixels, on cells'
    edges and outside the tile; op below, at and above 1/255) and on
    random pairs over four decades of scale. Below 1/255 it keeps no cell.
  * Its ranges are the ranges: a 65 x 65 grid over each cell's box
    (float64) lies inside [lo, hi] up to 1e-6 of the terms' magnitude (the
    float32 rounding of the range, ~4e-7 of it, a hundredth of the test's
    margin), and its least and largest values come within 1e-2 of it of
    lo and hi.
  * An input whose tiles stop mid-run (kernel_skel_bench.make_stop): the
    plain version within max abs 1e-5 of the numpy restatement of the JAX
    kernel (tests/test_torch_cumsum_skel.py, the transmittance products in
    another order), and it walks fewer columns than are in range.
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.profiling import kernel_skel_bench as skel
from test_torch_cumsum_skel import _skel_numpy

PIX = torch.arange(skel.P)
PX = (PIX % 16).to(torch.float32)
PY = torch.div(PIX, 16, rounding_mode="floor").to(torch.float32)


def _valid(x, y, a, b, c, op):
    """[n, 256]: whether each pixel passes the alpha test, in float32 as
    the kernel and the plain version compute it."""
    dx = x[:, None] - PX
    dy = y[:, None] - PY
    sigma = (0.5 * a)[:, None] * (dx * dx) + (0.5 * c)[:, None] * (dy * dy) \
        + b[:, None] * (dx * dy)
    alpha = torch.clamp(op[:, None] * torch.exp(-sigma), max=skel.MAX_ALPHA)
    return (sigma >= 0.0) & (alpha >= skel.ALPHA_THRESHOLD)


def _uncovered(cols):
    """The (pair, pixel) slots that pass the alpha test in a cell that the
    test leaves out, and the cell bits."""
    bits = skel._cell_bits(*cols)
    valid = _valid(*cols)
    return valid & ~bits[:, skel._pixel_cells(torch.device("cpu"))], bits


@pytest.mark.parametrize("which", range(len(skel.INPUTS)))
def test_cell_test_keeps_every_composited_slot(which):
    T, avg_len, term, _ = skel.INPUTS[which]
    rows, starts, ends, _ = skel.make(T, avg_len, term)
    n = 40
    tr.reset_launch_counts()
    _, c = skel._skel_plain(torch.as_tensor(rows),
                            torch.as_tensor(starts[:n]),
                            torch.as_tensor(ends[:n]), with_counts=True)
    assert tr.LAUNCHES["skel_composite"] == 0
    assert c["missed"] == 0
    assert 0 < c["composited"] < c["candidate"] < c["evaluated"]
    assert c["candidate"] == c["cell_hits"] * 32 * skel.SKEL_PPT
    assert c["cell_tests"] == c["columns"] * skel.CELLS_X * skel.CELLS_Y
    # the skeleton's centres sit near pixel (0, 0): no tile saturates
    assert c["tiles_stopped"] == 0
    assert c["columns"] == c["columns_in_range"]


def test_cell_test_on_constructed_pairs():
    rows, starts, ends, _ = skel.make_edges()
    n = int(ends.max())
    cols = tuple(torch.as_tensor(rows[i, :n]) for i in range(6))
    missed, bits = _uncovered(cols)
    assert not bool(missed.any())
    op = cols[5]
    assert not bool(bits[op < skel.ALPHA_THRESHOLD].any())
    valid = _valid(*cols)
    assert bool(valid[op < skel.ALPHA_THRESHOLD].sum() == 0)
    # at op = 1/255 only sigma = 0 passes: a centre on a pixel, or a
    # conic that vanishes there
    at = op == np.float32(skel.ALPHA_THRESHOLD)
    assert bool(valid[at].any()) and bool(bits[at].any())
    # a negative-definite conic centred on pixel (7, 7) passes there only
    neg = (cols[2] == -1.0) & (cols[0] == 7.0) & (cols[1] == 7.0) \
        & (op == np.float32(0.5))
    assert int(neg.sum()) == 1
    assert valid[neg].nonzero()[:, 1].tolist() == [7 * 16 + 7]
    assert bits[neg].tolist() == [[True, False, False, False]]
    # the tiles' walk: every composited slot in a kept cell
    _, c = skel._skel_plain(*map(torch.as_tensor, (rows, starts, ends)),
                            with_counts=True)
    assert c["missed"] == 0 and c["composited"] > 0


def test_cell_test_on_random_pairs(rng):
    n = 4096
    x, y = rng.uniform(-24.0, 40.0, (2, n))
    a, b, c = rng.standard_normal((3, n)) * 10.0 ** rng.uniform(-3, 1, (3, n))
    op = 10.0 ** rng.uniform(-3.0, 0.0, n)
    cols = tuple(torch.as_tensor(v.astype(np.float32))
                 for v in (x, y, a, b, c, op))
    missed, bits = _uncovered(cols)
    assert not bool(missed.any())
    assert 0.05 < float(bits.double().mean()) < 0.95


def test_cell_ranges_are_the_ranges(rng):
    n = 256
    x, y = rng.uniform(-10.0, 26.0, (2, n))
    a, b, c = rng.standard_normal((3, n))
    cols = [torch.as_tensor(v.astype(np.float32)) for v in (x, y, a, b, c)]
    lo, hi, m = (r.double() for r in skel._cell_ranges(*cols))
    X, Y, B = (v.double() for v in (cols[0], cols[1], cols[3]))
    A, C = (0.5 * cols[2]).double(), (0.5 * cols[4]).double()
    g = torch.linspace(0.0, 1.0, 65, dtype=torch.float64)
    for cell in range(skel.CELLS_X * skel.CELLS_Y):
        cy, cx = divmod(cell, skel.CELLS_X)
        px = cx * skel.CELL_W + g * (skel.CELL_W - 1)
        py = cy * skel.CELL_H + g * (skel.CELL_H - 1)
        u = X[:, None, None] - px[None, :, None]
        v = Y[:, None, None] - py[None, None, :]
        q = (A[:, None, None] * (u * u) + B[:, None, None] * (u * v)
             + C[:, None, None] * (v * v)).flatten(1)
        scale = (m[:, cell] - skel.RANGE_ABS) / skel.RANGE_REL + 1.0
        assert bool((q.amin(1) >= lo[:, cell] - 1e-6 * scale).all())
        assert bool((q.amax(1) <= hi[:, cell] + 1e-6 * scale).all())
        assert bool((q.amin(1) - lo[:, cell] <= 1e-2 * scale).all())
        assert bool((hi[:, cell] - q.amax(1) <= 1e-2 * scale).all())


def test_plain_on_stopping_input_matches_numpy():
    rows, starts, ends, _ = skel.make_stop(16, 640, seed=2)
    ref = _skel_numpy(rows, starts, ends)
    got, c = skel._skel_plain(*map(torch.as_tensor, (rows, starts, ends)),
                              with_counts=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert float(np.abs(ref).max()) > 0.1
    assert c["tiles_stopped"] > 0
    assert c["columns"] < c["columns_in_range"]
    assert c["missed"] == 0 and c["composited"] > c["candidate"] // 4
