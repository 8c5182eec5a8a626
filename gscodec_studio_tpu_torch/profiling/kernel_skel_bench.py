"""The compositing skeleton's microbenchmark on the card (port of
profiling/kernel_skel_bench.py): B11, a tile walk over attribute-major
rows [16, cap] with soft compositing and a per-tile stop at chunk
granularity (csrc/skel_composite.cu), timed on the JAX script's four
inputs.

    python3 -m gscodec_studio_tpu_torch.profiling.kernel_skel_bench

prints, for each input, the kernel's time, per tile and per intersection,
and the card's name and power limit. ``make`` draws the inputs with numpy
from the JAX script's seeds; ``skel_composite`` launches the kernel for
CUDA tensors and runs its plain version ``_skel_plain`` for CPU tensors.
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


def _skel_plain(rows, starts, ends, with_counts: bool = False):
    """Plain version of B11: loops over a chunk's place in its tile's walk
    and vectorises across tiles. Returns out [T, 256, 3]; with
    ``with_counts`` also the (pair, pixel) slots of the walked columns in
    the tiles' runs ("evaluated"), those composited, and the columns."""
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
              for k in ("evaluated", "composited", "columns")}
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
                counts["evaluated"] += inr.sum() * P
                counts["composited"] += valid.sum()
                counts["columns"] += inr.sum()
    if with_counts:
        return out, {k: int(v) for k, v in counts.items()}
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
