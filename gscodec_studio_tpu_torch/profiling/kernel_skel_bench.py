"""The compositing skeleton's microbenchmark on the card (port of
profiling/kernel_skel_bench.py): B11, a tile walk over attribute-major
rows [16, cap] with soft compositing and a per-tile stop at chunk
granularity (csrc/skel_composite.cu), timed on the JAX script's four
inputs.

    python3 -m gscodec_studio_tpu_torch.profiling.kernel_skel_bench

prints, for each input, the kernel's time, per tile and per intersection,
and the card's name and power limit. ``make`` draws the inputs with numpy
from the JAX script's seeds, ``make_stop`` an input whose tiles stop
before their runs end; ``skel_composite`` launches the kernel for CUDA
tensors and runs its plain version ``_skel_plain`` for CPU tensors.
``_cell_bits`` mirrors the kernel's cell test, and ``_skel_plain(...,
with_counts=True)`` counts the kernel's work in its layout.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional

import numpy as np
import torch

from gscodec_studio_tpu_torch import native
from gscodec_studio_tpu_torch.ops.raster_v2 import (LAUNCHES, _check_cuda,
                                                    _composite, _on_cpu,
                                                    _stream)

K = 128  # columns per chunk
D = 16  # attribute rows of the table
P = 256  # pixels of a 16 x 16 tile
CH = 3
ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999
# csrc/skel_composite.cu's layout: SKEL_PPT pixels a thread, neighbours in
# one tile row; a warp's 64 pixels a cell CELL_W x CELL_H, the cells
# row-major (cell cy * CELLS_X + cx is warp cy * CELLS_X + cx's)
SKEL_PPT = 2
CELL_W = 8
CELL_H = 32 * SKEL_PPT // CELL_W
CELLS_X, CELLS_Y = 16 // CELL_W, 16 // CELL_H
# the cell test's margins (kRangeRel, kRangeAbs, kLogMargin there)
RANGE_REL = 1e-4
RANGE_ABS = 1e-4
LOG_MARGIN = 1e-4

# (tiles, mean run length, stop after about this many opaque pairs, label)
INPUTS = (
    (8160, 640, None, "8160 tiles x 640 rows, no term"),
    (8160, 640, 24.0, "8160 tiles x 640 rows, term@24"),
    (8160, 640, 100.0, "8160 tiles x 640 rows, term@100"),
    (8160, 64, None, "8160 tiles x 64 rows, no term"),
)


def make(T: int, avg_len: float, term_after: Optional[float] = None,
         seed: int = 0):
    """The JAX script's input: Poisson run lengths, standard-normal rows
    [16, cap], opacities 0.02 or 1 - 1e-4^(1 / term_after). Returns numpy
    (rows, starts, ends, cap)."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(avg_len, T).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cap = ((int(starts[-1]) + K - 1) // K + 1) * K
    rows = rng.standard_normal((D, cap)).astype(np.float32)
    op = np.full(cap, 0.02, np.float32)
    if term_after is not None:
        op[:] = 1.0 - (1e-4) ** (1.0 / term_after)
    rows[5] = op
    return rows, starts[:-1], starts[:-1] + lens, cap


def make_stop(T: int, avg_len: float, seed: int = 0):
    """An input whose tiles stop before their runs end: make's rows with
    centres uniform over the tile, positive-definite conics (the inverse of
    a covariance with axes of 1.5 to 4 pixels at a random angle) and
    opacities between 0.85 and 0.95, so that a tile's pixels saturate.
    Returns numpy (rows, starts, ends, cap)."""
    rows, starts, ends, cap = make(T, avg_len, None, seed)
    rng = np.random.default_rng(seed + 1)
    rows[0:2] = rng.uniform(-0.5, 15.5, (2, cap))
    s = rng.uniform(1.5, 4.0, (2, cap))
    th = rng.uniform(0.0, np.pi, cap)
    cs, sn = np.cos(th), np.sin(th)
    # inv(R diag(s^2) R^T) = R diag(s^-2) R^T
    i0, i1 = s[0] ** -2, s[1] ** -2
    rows[2] = cs * cs * i0 + sn * sn * i1
    rows[3] = cs * sn * (i0 - i1)
    rows[4] = sn * sn * i0 + cs * cs * i1
    rows[5] = rng.uniform(0.85, 0.95, cap)
    return rows, starts, ends, cap


def make_edges(T: int = 64, seed: int = 0):
    """Constructed pairs at the cell test's edges: indefinite,
    negative-definite, near-singular and degenerate conics, centred on
    pixels, on cells' edges, between pixels and outside the tile, at
    opacities below, at and above 1/255; each tile a run over them.
    Returns numpy (rows, starts, ends, cap)."""
    conics = ((1.0, 0.0, -1.0), (0.3, 2.0, 0.3), (-1.0, 0.2, -0.5),
              (1.0, 1.0 - 1e-7, 1.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0),
              (0.0, 0.0, 0.0), (2.0, 0.0, 0.0), (0.0, 0.0, -3.0),
              (0.02, -0.01, 0.05), (-0.3, 1.5, 0.7), (40.0, 0.0, 40.0))
    centres = ((0.0, 0.0), (7.0, 7.0), (7.5, 8.0), (8.0, 7.5),
               (15.0, 15.0), (3.25, 11.75), (-0.5, 16.5), (40.0, -30.0),
               (8.0, 8.0), (-6.0, 4.0))
    ops = (0.0039, float(np.float32(ALPHA_THRESHOLD)), 0.02, 0.5, 0.999)
    cols = np.array([(x, y, a, b, c, op) for a, b, c in conics
                     for x, y in centres for op in ops], np.float32).T
    n = cols.shape[1]
    cap = ((n + K - 1) // K + 1) * K
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((D, cap)).astype(np.float32)
    rows[:6, :n] = cols
    starts = rng.integers(0, n, T).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, 300, T), n).astype(np.int32)
    return rows, starts, ends, cap


def _cell_ranges(x, y, a, b, c):
    """The range of each pair's sigma over each cell, as
    csrc/skel_composite.cu's cell_bits forms it (float32, the same
    operations in the same order), on float32 pairs of any shape: (lo, hi,
    m), each [..., CELLS_Y * CELLS_X] (cells row-major). sigma(dx, dy) =
    A dx^2 + b dx dy + C dy^2 (A = 0.5 a, C = 0.5 c) over the cell's box of
    dx = x - px, dy = y - py, from the corners, the edges' critical points
    and the origin; m = RANGE_REL (|A| mu^2 + |b| mu mv + |C| mv^2) +
    RANGE_ABS with mu, mv the box's largest |dx|, |dy|."""
    A, C = 0.5 * a, 0.5 * c

    def quad(u, v):
        return (A * (u * u) + b * (u * v)) + C * (v * v)

    def crit(den):  # -b / (2 den) where den != 0, else 0
        nz = den != 0.0
        return nz, torch.where(nz, -b / (2.0 * torch.where(nz, den, 1.0)),
                               torch.zeros((), dtype=x.dtype))

    nz_a, kx = crit(A)
    nz_c, ky = crit(C)
    ranges = []
    for cy in range(CELLS_Y):
        v0 = y - float(cy * CELL_H + CELL_H - 1)
        v1 = y - float(cy * CELL_H)
        for cx in range(CELLS_X):
            u0 = x - float(cx * CELL_W + CELL_W - 1)
            u1 = x - float(cx * CELL_W)
            corners = [quad(u, v) for u in (u0, u1) for v in (v0, v1)]
            lo = hi = corners[0]
            for q in corners[1:]:
                lo, hi = torch.minimum(lo, q), torch.maximum(hi, q)
            inside = [(nz_a & (kx * v >= u0) & (kx * v <= u1), quad(kx * v, v))
                      for v in (v0, v1)]
            inside += [(nz_c & (ky * u >= v0) & (ky * u <= v1),
                        quad(u, ky * u)) for u in (u0, u1)]
            inside.append(((u0 <= 0) & (u1 >= 0) & (v0 <= 0) & (v1 >= 0),
                           torch.zeros_like(x)))
            for take, q in inside:
                lo = torch.where(take, torch.minimum(lo, q), lo)
                hi = torch.where(take, torch.maximum(hi, q), hi)
            mu = torch.maximum(u0.abs(), u1.abs())
            mv = torch.maximum(v0.abs(), v1.abs())
            m = RANGE_REL * ((A.abs() * (mu * mu) + b.abs() * (mu * mv))
                             + C.abs() * (mv * mv)) + RANGE_ABS
            ranges.append((lo, hi, m))
    return tuple(torch.stack(r, -1) for r in zip(*ranges))


def _cell_bits(x, y, a, b, c, op):
    """csrc/skel_composite.cu's cell test (cell_bits): bool [...,
    CELLS_Y * CELLS_X], whether a pixel of each cell can pass the alpha
    test. A cell is out when its range of sigma (_cell_ranges) lies below
    -m or above L + m, L = ln(255 op) + LOG_MARGIN in float32; every cell
    is out where op < 1/255. The margins lie far above the float32
    rounding of the range and of a pixel's sigma (~4e-7 of the terms'
    magnitude) and of its alpha test (~3e-7 of sigma)."""
    lo, hi, m = _cell_ranges(x, y, a, b, c)
    L = (torch.log(255.0 * op) + LOG_MARGIN)[..., None]
    ok = (op >= np.float32(ALPHA_THRESHOLD))[..., None]
    return ok & ~(hi < -m) & ~(lo > L + m)


def _pixel_cells(dev):
    """The cell of each of the 256 pixels, [P] int64."""
    p = torch.arange(P, device=dev)
    return (torch.div(p, 16 * CELL_H, rounding_mode="floor") * CELLS_X
            + torch.div(p % 16, CELL_W, rounding_mode="floor"))


def _skel_plain(rows, starts, ends, with_counts: bool = False):
    """Plain version of B11: loops over a chunk's place in its tile's walk
    and vectorises across tiles. Returns out [T, 256, 3]; with
    ``with_counts`` also the kernel's work in its layout: the (pair, pixel)
    slots of the walked columns in the tiles' runs ("evaluated"), those
    composited, the walked columns ("columns") and those in the runs
    ("columns_in_range"), the (pair, cell) tests of the walked columns and
    those that pass _cell_bits ("cell_tests", "cell_hits"), the slots of
    the passing (pair, cell)s ("candidate"), the composited slots outside
    them ("missed", which must be 0), and the tiles whose walk stopped
    before its last chunk ("tiles_stopped")."""
    dev = rows.device
    T = starts.shape[0]
    st, en = starts.to(torch.int64), ends.to(torch.int64)
    c0 = torch.div(st, K, rounding_mode="floor")
    n = torch.div(en + K - 1, K, rounding_mode="floor") - c0
    p = torch.arange(P, device=dev)
    px = (p % 16).to(torch.float32)[None, :, None]
    py = torch.div(p, 16, rounding_mode="floor").to(torch.float32)[
        None, :, None]
    lane = torch.arange(K, device=dev)
    out = torch.zeros((T, P, CH), dtype=torch.float32, device=dev)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("evaluated", "composited", "columns", "cell_tests",
                        "cell_hits", "candidate", "missed")}
    walked = torch.zeros(T, dtype=torch.int64, device=dev)
    cell_of = _pixel_cells(dev)
    group = max(1, (1 << 20 if rows.is_cuda else 1 << 16) // P)
    for g0 in range(0, T, group):
        sl = slice(g0, min(T, g0 + group))
        t_cur = torch.ones((sl.stop - sl.start, P, 1), dtype=torch.float32,
                           device=dev)
        for j in range(int(n[sl].max()) if sl.stop > sl.start else 0):
            live = (n[sl] > j) & (t_cur.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            xs, ys, ca, cb, cc, op = (r[:, None, :] for r in rows[:6, cols])
            dx = xs - px  # [A, P, K]
            dy = ys - py
            sigma = (0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy) \
                + cb * (dx * dy)
            inr = ((cols >= st[sl][idx, None])
                   & (cols < en[sl][idx, None]))[:, None, :]
            alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
            valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & inr
            alpha = torch.where(valid, alpha, torch.zeros((), device=dev))
            w, _, _, t_new = _composite(alpha, t_cur[idx], "soft")
            out[g0 + idx] += torch.einsum("apk,cak->apc", w, rows[6:9, cols])
            t_cur[idx] = t_new
            if with_counts:
                hits = _cell_bits(xs[:, 0], ys[:, 0], ca[:, 0], cb[:, 0],
                                  cc[:, 0], op[:, 0]) & inr[:, 0, :, None]
                cand = hits[:, :, cell_of].transpose(1, 2)  # [A, P, K]
                counts["evaluated"] += inr.sum() * P
                counts["composited"] += valid.sum()
                counts["columns"] += inr.sum()
                counts["cell_tests"] += inr.sum() * CELLS_X * CELLS_Y
                counts["cell_hits"] += hits.sum()
                counts["candidate"] += cand.sum()
                counts["missed"] += (valid & ~cand).sum()
                walked[g0 + idx] += 1
    if with_counts:
        res = {k: int(v) for k, v in counts.items()}
        res["columns_in_range"] = int((en - st).sum())
        res["tiles_stopped"] = int((walked < n).sum())
        return out, res
    return out


def skel_composite(rows, starts, ends):
    """B11: rows f32 [16, cap], starts/ends int32 [T] -> out [T, 256, 3]."""
    if rows.ndim != 2 or rows.shape[0] != D or starts.shape != ends.shape:
        raise ValueError("skel_composite: rows [16, cap], starts and ends "
                         "[T]")
    if _on_cpu(rows, "skel_composite"):
        return _skel_plain(rows, starts, ends)
    dev = rows.device
    _check_cuda("skel_composite rows", rows, torch.float32, dev)
    _check_cuda("skel_composite starts", starts, torch.int32, dev)
    _check_cuda("skel_composite ends", ends, torch.int32, dev)
    T = starts.shape[0]
    out = torch.empty((T, P, CH), dtype=torch.float32, device=dev)
    err = native.lib().gsc_skel_composite(
        rows.data_ptr(), rows.shape[1], starts.data_ptr(), ends.data_ptr(),
        T, out.data_ptr(), _stream())
    native.check(err, "gsc_skel_composite")
    LAUNCHES["skel_composite"] += 1
    return out


def bench(reps: int = 5) -> List[dict]:
    """B11 on each of INPUTS on the card: mean time of ``reps`` launches
    after one (CUDA events), per tile and per intersection."""
    dev = torch.device("cuda")
    res = []
    for T, avg_len, term, label in INPUTS:
        rows, starts, ends, cap = make(T, avg_len, term)
        rows, starts, ends = (torch.as_tensor(a, device=dev)
                              for a in (rows, starts, ends))
        n_isect = int((ends - starts).sum())
        skel_composite(rows, starts, ends)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            skel_composite(rows, starts, ends)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / reps
        res.append(dict(label=label, tiles=T, n_isect=n_isect, cap=cap,
                        ms=ms, us_per_tile=ms / T * 1e3,
                        ns_per_isect=ms / n_isect * 1e6))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_skel_bench: no CUDA device")
        return 1
    for r in bench():
        print(f"{r['label']:38s} {r['ms']:8.3f} ms  "
              f"{r['us_per_tile']:6.3f} us/tile  "
              f"{r['ns_per_isect']:6.3f} ns/isect", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
