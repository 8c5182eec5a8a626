"""Legacy v1 tile rasterizer, forward and backward (port of
gscodec_studio_tpu/ops/rasterize_pallas.py, the ``rasterizer="pallas"``
backend).

Pipeline, as in the JAX package:
  1. the sorted intersection list (ops/isect.py) re-laid with every tile's
     run padded to 128-row chunks (``align_isects``);
  2. ``_pack``: the [C*N, 6 + CH] attribute rows (x, y, conic a, b, c,
     opacity, colours) gathered into aligned order [cap2, 6 + CH]; an
     index of -1 (alignment padding) reads a zero pad row;
  3. B7 ``raster_v1_fwd`` (csrc/raster_v1_fwd.cu): per tile, front-to-back
     compositing over its chunks with a per-chunk, per-tile stop, into
     [T, CH, P] colours and [T, 1, P] alphas;
  4. tile-to-image assembly and backgrounds.
Backward (``_RasterizePacked.backward``):
  5. B8 ``raster_v1_bwd`` (csrc/raster_v1_bwd.cu): the forward's walk
     replayed, each aligned row's gradient summed over its tile's pixels
     into [cap2, 6 + CH]; rows no tile computes are 0;
  6. the per-Gaussian reduction, chosen by the module switch
     ``SEGRED_MODE``: "sort" (sort the rows by Gaussian id, f32 cumulative
     sums, differences at the expansion offsets), "scatter" (one
     ``index_add_`` by id) or "cumsum" (rows back to expansion order
     through the inverse permutation, then cumulative-sum differences).

Steps 1, 2 and 6 are XLA code outside Pallas in the JAX package and stay
plain PyTorch here, but for the running sums of the "sort" and "cumsum"
reductions, which B10 (``raster_v2.cumsum_rows``, csrc/cumsum_rows.cu, the
JAX package's row-scan kernel) takes on the transposed [6 + CH, cap2]
table; on CPU tensors that is torch.cumsum. The "sort" reduction takes
differences of running f32 sums over the whole table, as the JAX package
does; chip_smoke.py holds each per-Gaussian sum within the rounding bound
of those differences (raster_v2.cumsum_rows_bound).

B7 and B8 skip the pixels outside each pair's candidate region, the box of
its opacity ellipse and a bound on its float sigma (raster_v2._pair_regions,
csrc/regions.cuh), in the layout and builds of B1 and B2
(raster_v2.fwd_build and bwd_build, without their dense build);
``_region_counts`` counts that work from the plain walk. Where a backward
follows, both take the tiles longest run first (``run_order``).

``CUTOFF_MODE`` ("soft", the JAX package's default; the JAX tests set
"exact") and ``SEGRED_MODE`` are read when ``rasterize_to_pixels`` is
called and travel in its RasterCfg to the backward. "exact": a pixel takes
the pairs of a chunk while T * (1 - alpha) > 1e-4 and none after the first
that fails; the next chunk tries again from the T it reached. "soft": every
pair of a live chunk composites. In both, a tile stops at a chunk boundary
once all of its P pixels (those past the image's edge too) have
T <= 1e-4.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and counts
the launch in ``raster_v2.LAUNCHES``; for CPU tensors it runs the plain
PyTorch version beside it (``_fwd_plain``, ``_bwd_plain``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gscodec_studio_tpu_torch import native
from gscodec_studio_tpu_torch.ops.isect import (AlignedIsects, Intersections,
                                                align_isects)
from gscodec_studio_tpu_torch.ops.raster_v2 import (LAUNCHES, MAX_CHANNELS,
                                                    _cell_bounds,
                                                    _check_cuda, _composite,
                                                    _on_cpu, _pair_regions,
                                                    _stream, _warp_layout,
                                                    bwd_pixels_per_thread,
                                                    cumsum_rows)

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999

K_CHUNK = 128  # rows per chunk == the alignment unit of the runs

# The backward's per-Gaussian reduction: "sort", "scatter" or "cumsum"
# (module docstring). Read when rasterize_to_pixels is called.
SEGRED_MODE = "sort"

# Early termination: "exact" or "soft" (module docstring). Read when
# rasterize_to_pixels is called.
CUTOFF_MODE = "soft"

SEGRED_MODES = ("sort", "scatter", "cumsum")


@dataclass(frozen=True)
class RasterCfg:
    C: int
    tile_width: int
    tile_height: int
    tile_size: int
    channels: int
    cap: int  # unaligned intersection capacity
    cap2: int  # aligned capacity (a multiple of K_CHUNK)
    m: int = 0  # rows of the attribute table (C*N)
    cutoff: str = "soft"
    segred: str = "sort"

    @property
    def n_tiles(self) -> int:
        return self.C * self.tile_width * self.tile_height

    @property
    def pixels(self) -> int:
        return self.tile_size * self.tile_size

    @property
    def d(self) -> int:
        return 6 + self.channels

    @property
    def n_chunks(self) -> int:
        return self.cap2 // K_CHUNK


def _chunk_tile_map(cfg: RasterCfg, starts, ends) -> torch.Tensor:
    """Chunk index -> owning tile, n_tiles for the chunks of no run. The
    runs are K-aligned and consecutive, so a chunk belongs to the last
    tile whose aligned start is at or before its first row."""
    i32 = torch.int32
    chunk_row = torch.arange(cfg.n_chunks, dtype=i32,
                             device=starts.device) * K_CHUNK
    last = torch.div(ends[-1:] + K_CHUNK - 1, K_CHUNK,
                     rounding_mode="floor") * K_CHUNK
    aligned_ends = torch.cat([starts[1:], last])
    tile = torch.searchsorted(starts, chunk_row, right=True).to(i32) - 1
    in_run = chunk_row < aligned_ends[tile.to(torch.int64)]
    return torch.where(in_run, tile, cfg.n_tiles).to(i32)


def _pack(flat_attrs, aligned_ids) -> torch.Tensor:
    """[M, D] attributes + one zero pad row, gathered to aligned order
    [cap2, D]; an id of -1 reads the pad row M."""
    M = flat_attrs.shape[0]
    flat = torch.cat([flat_attrs, flat_attrs.new_zeros(
        (1, flat_attrs.shape[1]))])
    idx = torch.where(aligned_ids >= 0, aligned_ids, M).to(torch.int64)
    return flat.index_select(0, idx)


# ---------------------------------------------------------------------------
# The plain chunk walk (what _fwd_kernel and _bwd_kernel compute)
# ---------------------------------------------------------------------------


def _walk(cfg: RasterCfg, starts, ends, device):
    """Per tile: the aligned row of its first chunk, its number of chunks
    (from the chunk map), its pixel centres [T, P] and how many tiles to
    vectorise at a time (2^20 tile pixels on a card, 2^16 on the CPU)."""
    nT, P, ts, TW = cfg.n_tiles, cfg.pixels, cfg.tile_size, cfg.tile_width
    chunk_tile = _chunk_tile_map(cfg, starts, ends)
    nch = torch.bincount(chunk_tile.to(torch.int64),
                         minlength=nT + 1)[:nT]
    rem = torch.arange(nT, device=device) % (TW * cfg.tile_height)
    p = torch.arange(P, device=device)
    px = ((rem % TW)[:, None] * ts + p % ts).to(torch.float32) + 0.5
    py = (torch.div(rem, TW, rounding_mode="floor")[:, None] * ts
          + torch.div(p, ts, rounding_mode="floor")).to(torch.float32) + 0.5
    group = max(1, (1 << 20 if device.type == "cuda" else 1 << 16) // P)
    return starts.to(torch.int64), nch, px, py, group


def _chunk_geometry(buf, px, py, rows, end):
    """Pair math of one chunk per tile. buf [A, K, D] rows, px/py [A, P],
    rows [A, K] their aligned indices, end [A]. Returns [A, P, K] maps."""
    xs, ys = buf[:, None, :, 0], buf[:, None, :, 1]
    ca, cb, cc = buf[:, None, :, 2], buf[:, None, :, 3], buf[:, None, :, 4]
    op = buf[:, None, :, 5]
    dx = xs - px[:, :, None]
    dy = ys - py[:, :, None]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    in_range = (rows < end[:, None])[:, None, :]
    alpha_raw = op * torch.exp(-sigma)
    alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
    valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_range
    alpha = torch.where(valid, alpha, torch.zeros((), device=buf.device))
    return dict(dx=dx, dy=dy, ca=ca, cb=cb, cc=cc, sigma=sigma, alpha=alpha,
                valid=valid, clamped=alpha_raw > MAX_ALPHA, in_range=in_range)


def _fwd_plain(packed, starts, ends, cfg: RasterCfg,
               with_counts: bool = False):
    """Plain version of B7: loops over a chunk's place in its tile's run and
    vectorises across tiles. Returns (colors [T, CH, P], alphas [T, 1, P]);
    with ``with_counts`` also the (pair, pixel) counts of what the kernel
    does: "evaluated" pairs (in exact mode those up to and including the
    one that ends the pixel's chunk), "tested" (past the alpha test),
    "composited" (added to the colours), and the chunks walked."""
    dev = packed.device
    nT, P, CH = cfg.n_tiles, cfg.pixels, cfg.channels
    first, nch, px, py, group = _walk(cfg, starts, ends, dev)
    lane = torch.arange(K_CHUNK, device=dev)
    colors = torch.zeros((nT, CH, P), dtype=torch.float32, device=dev)
    alphas = torch.zeros((nT, 1, P), dtype=torch.float32, device=dev)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("evaluated", "tested", "composited", "chunks")}
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((n, P, CH), dtype=torch.float32, device=dev)
        for j in range(int(nch[sl].max()) if n else 0):
            live = (nch[sl] > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            rows = (first[sl][idx] + j * K_CHUNK)[:, None] + lane  # [A, K]
            buf = packed[rows]  # [A, K, D]
            g = _chunk_geometry(buf, px[sl][idx], py[sl][idx], rows,
                                ends[sl][idx])
            w, _, _, t_new = _composite(g["alpha"], T[idx], cfg.cutoff)
            acc[idx] += torch.einsum("apk,akc->apc", w, buf[:, :, 6:])
            T[idx] = t_new
            if with_counts:
                valid, inr = g["valid"], g["in_range"].expand_as(g["valid"])
                if cfg.cutoff == "soft":
                    comp, seen = valid, inr
                else:  # up to the first valid pair that is not composited
                    comp = w > 0.0
                    stop = (valid & ~comp).to(torch.int32)
                    seen = inr & ((torch.cumsum(stop, dim=-1) - stop) == 0)
                counts["evaluated"] += seen.sum()
                counts["tested"] += (seen & valid).sum()
                counts["composited"] += comp.sum()
                counts["chunks"] += idx.numel()
        visited = (nch[sl] > 0)[:, None]
        colors[sl] = acc.transpose(1, 2)
        alphas[sl, 0] = torch.where(visited, 1.0 - T[..., 0],
                                    torch.zeros((), device=dev))
    if with_counts:
        return colors, alphas, {k: int(v) for k, v in counts.items()}
    return colors, alphas


def _bwd_plain(packed, starts, ends, v_colors, v_alphas, alphas, q_init,
               cfg: RasterCfg):
    """Plain version of B8: the forward's walk again, carrying T and
    q = sum_ch C_total * v_c; each live chunk's rows get the 6 + CH
    gradient terms summed over the tile's pixels. Returns [cap2, 6 + CH]
    with 0 in every row the walk does not reach."""
    dev = packed.device
    nT, P = cfg.n_tiles, cfg.pixels
    first, nch, px, py, group = _walk(cfg, starts, ends, dev)
    lane = torch.arange(K_CHUNK, device=dev)
    out = torch.zeros((cfg.cap2, cfg.d), dtype=torch.float32, device=dev)
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        q = q_init[sl, 0].clone()  # [n, P]
        for j in range(int(nch[sl].max()) if n else 0):
            live = (nch[sl] > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            rows = (first[sl][idx] + j * K_CHUNK)[:, None] + lane
            buf = packed[rows]
            g = _chunk_geometry(buf, px[sl][idx], py[sl][idx], rows,
                                ends[sl][idx])
            alpha = g["alpha"]
            w, m, t_prev, t_new = _composite(alpha, T[idx], cfg.cutoff)
            v_c = v_colors[sl][idx]  # [A, CH, P]
            v_a = v_alphas[sl][idx][:, 0, :, None]  # [A, P, 1]
            t_final = 1.0 - alphas[sl][idx][:, 0, :, None]
            q_row = q[idx][:, :, None]
            G = torch.einsum("akc,acp->apk", buf[:, :, 6:], v_c)
            u = w * G
            s = q_row - torch.cumsum(u, dim=-1)
            oma = 1.0 - alpha
            inv_oma = 1.0 / torch.where(oma > 0, oma, torch.ones((),
                                                                device=dev))
            v_alpha = t_prev * G - s * inv_oma + v_a * t_final * inv_oma
            if m is not None:
                v_alpha = v_alpha * m.to(v_alpha.dtype)
            dvalid = (g["valid"] & ~g["clamped"]).to(alpha.dtype)
            v_sig = -alpha * v_alpha * dvalid
            dx, dy = g["dx"], g["dy"]
            ca, cb, cc = g["ca"], g["cb"], g["cc"]
            geo = torch.stack([
                (v_sig * (ca * dx + cb * dy)).sum(1),
                (v_sig * (cc * dy + cb * dx)).sum(1),
                (v_sig * 0.5 * dx * dx).sum(1),
                (v_sig * dx * dy).sum(1),
                (v_sig * 0.5 * dy * dy).sum(1),
                (v_alpha * torch.exp(-g["sigma"]) * dvalid).sum(1),
            ], dim=-1)  # [A, K, 6]
            vcol = torch.einsum("apk,acp->akc", w, v_c)
            out[rows.reshape(-1)] = torch.cat([geo, vcol], -1).reshape(
                -1, cfg.d)
            T[idx] = t_new
            q[idx] = q[idx] - u.sum(-1)
    return out


# ---------------------------------------------------------------------------
# B7 and B8 (csrc/raster_v1_fwd.cu, csrc/raster_v1_bwd.cu)
# ---------------------------------------------------------------------------


def _check_args(name, packed, starts, ends, cfg: RasterCfg):
    if packed.shape != (cfg.cap2, cfg.d) or starts.shape != (cfg.n_tiles,) \
            or ends.shape != (cfg.n_tiles,):
        raise ValueError(f"{name}: packed, starts or ends has the wrong "
                         "shape")
    if cfg.cutoff not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff {cfg.cutoff!r}")


def _check_kernel_cfg(name, cfg: RasterCfg):
    if cfg.channels > MAX_CHANNELS:
        raise NotImplementedError(
            f"{name} takes at most {MAX_CHANNELS} channels, got "
            f"{cfg.channels}")
    if cfg.pixels > 1024:
        raise ValueError("tile_size above 32 does not fit one CUDA block")


def _order_arg(order, dev) -> int:
    if order is None:
        return 0
    _check_cuda("tile order", order, torch.int32, dev)
    return order.data_ptr()


def run_order(starts, ends) -> torch.Tensor:
    """The tiles, longest run first (int32 [n_tiles]): the order in which
    B7's and B8's blocks take them in training (raster_v1_fwd's and
    raster_v1_bwd's ``order``; rasterize_to_pixels makes one a binning
    where a backward follows), so that a tile whose run is many times the
    mean starts first instead of ending the launch."""
    return torch.argsort(ends - starts, descending=True).to(torch.int32)


def raster_v1_fwd(packed, starts, ends, cfg: RasterCfg, order=None):
    """Aligned table [cap2, 6 + CH] -> (colors [T, CH, P], alphas
    [T, 1, P]); a tile with an empty run gives 0 and 0. ``order`` (int32
    [n_tiles], e.g. run_order) is the tile each of B7's blocks takes, index
    order if None; the outputs do not depend on it."""
    _check_args("raster_v1_fwd", packed, starts, ends, cfg)
    if _on_cpu(packed, "raster_v1_fwd"):
        return _fwd_plain(packed, starts, ends, cfg)
    dev = packed.device
    _check_kernel_cfg("raster_v1_fwd", cfg)
    _check_cuda("raster_v1_fwd packed", packed, torch.float32, dev)
    _check_cuda("raster_v1_fwd starts", starts, torch.int32, dev)
    _check_cuda("raster_v1_fwd ends", ends, torch.int32, dev)
    colors = torch.empty((cfg.n_tiles, cfg.channels, cfg.pixels),
                         dtype=torch.float32, device=dev)
    alphas = torch.empty((cfg.n_tiles, 1, cfg.pixels), dtype=torch.float32,
                         device=dev)
    err = native.lib().gsc_raster_v1_fwd(
        packed.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        _order_arg(order, dev), cfg.n_tiles, cfg.tile_width,
        cfg.tile_height, cfg.tile_size, cfg.channels,
        int(cfg.cutoff == "soft"), colors.data_ptr(), alphas.data_ptr(),
        _stream())
    native.check(err, "gsc_raster_v1_fwd")
    LAUNCHES["raster_v1_fwd"] += 1
    return colors, alphas


def raster_v1_bwd(packed, starts, ends, colors, alphas, v_colors, v_alphas,
                  cfg: RasterCfg, order=None):
    """Per aligned row, its gradient terms summed over its tile's pixels,
    [cap2, 6 + CH]: d(x, y), d(conic a, b, c), d opacity, d colours; 0 in
    every row no live chunk holds. ``colors`` and ``alphas`` are B7's
    outputs, ``v_colors`` and ``v_alphas`` their cotangents; ``order`` as
    raster_v1_fwd's (the rows do not depend on it)."""
    _check_args("raster_v1_bwd", packed, starts, ends, cfg)
    # q_init[t] = sum_ch C_total[t] * v_c[t] (the JAX package's prepass)
    q_init = (colors * v_colors).sum(1, keepdim=True)
    if _on_cpu(packed, "raster_v1_bwd"):
        return _bwd_plain(packed, starts, ends, v_colors, v_alphas, alphas,
                          q_init, cfg)
    dev = packed.device
    _check_kernel_cfg("raster_v1_bwd", cfg)
    _check_cuda("raster_v1_bwd packed", packed, torch.float32, dev)
    _check_cuda("raster_v1_bwd starts", starts, torch.int32, dev)
    _check_cuda("raster_v1_bwd ends", ends, torch.int32, dev)
    for name, t in (("v_colors", v_colors), ("v_alphas", v_alphas),
                    ("alphas", alphas), ("q_init", q_init)):
        _check_cuda(f"raster_v1_bwd {name}", t, torch.float32, dev)
    out = torch.zeros((cfg.cap2, cfg.d), dtype=torch.float32, device=dev)
    err = native.lib().gsc_raster_v1_bwd(
        packed.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        _order_arg(order, dev), v_colors.data_ptr(), v_alphas.data_ptr(),
        alphas.data_ptr(), q_init.data_ptr(), cfg.n_tiles, cfg.tile_width,
        cfg.tile_height, cfg.tile_size, cfg.channels,
        int(cfg.cutoff == "soft"), out.data_ptr(), _stream())
    native.check(err, "gsc_raster_v1_bwd")
    LAUNCHES["raster_v1_bwd"] += 1
    return out


# ---------------------------------------------------------------------------
# What B7 and B8 do: the work of their walk
# ---------------------------------------------------------------------------


def _region_counts(packed, starts, ends, cfg: RasterCfg, ppt=None):
    """What B7 and B8 do on these inputs, from the plain walk (the tile's
    stop vote at each chunk), in the layout of ``ppt`` pixels a lane
    (raster_v2._warp_layout; bwd_pixels_per_thread's, B7's and B8's, if
    None),
    with the candidate regions B1 and B2 share (raster_v2._pair_regions,
    csrc/regions.cuh) formed from each row's f32 values. Returns a dict of
      "run": int64 [n_tiles], rows of the tile's run that the walk reaches;
      "pairs": int64 [n_tiles], pairs that at least one pixel composited;
      "slots": int64 [n_tiles], composited (pair, pixel) slots;
      "evaluated_slots": the (pair, pixel) slots walked, which the first
        designs evaluated (up to the exact cutoff: _fwd_plain's count);
      "candidate_slots": those of them in a warp whose cell meets the
        pair's box and whose float sigma is within the pair's bound lm;
      "missed_slots": slots that pass the alpha test outside the regions
        (0: the regions hold every pixel that passes);
      "tested", "composited": the slots that pass the alpha test (in
        exact mode up to the pixel's cutoff) and those composited;
      "pair_warp_walked", "pair_warp_cells" (those whose cell meets the
        pair's box), "pair_warp_candidates", "pair_warp_hits" (B8's warp
        reductions or ballot shortcuts) and "single_lane_hits";
      "longest_run", "longest_tile": the longest run the walk reaches and
        its tile; "warps_per_tile"."""
    dev = packed.device
    nT, P = cfg.n_tiles, cfg.pixels
    if ppt is None:
        ppt = bwd_pixels_per_thread(cfg.channels)
    first, nch, px, py, group = _walk(cfg, starts, ends, dev)
    lane = torch.arange(K_CHUNK, device=dev)
    n_warps, _, lane_of = _warp_layout(cfg.tile_size, ppt)
    lane_of = lane_of.to(dev)
    warp_of = torch.div(lane_of, 32, rounding_mode="floor")
    cells = [v.to(dev) for v in _cell_bounds(cfg, ppt)]
    i64 = dict(dtype=torch.int64, device=dev)
    counts = {k: torch.zeros(nT, **i64) for k in ("run", "pairs", "slots")}
    totals = {k: torch.zeros((), **i64) for k in (
        "evaluated_slots", "candidate_slots", "missed_slots", "tested",
        "composited", "pair_warp_walked", "pair_warp_cells",
        "pair_warp_candidates", "pair_warp_hits", "single_lane_hits")}

    def by_warp(mask):
        """[A, P, K] -> lanes hit [A, n_warps, K]."""
        A = mask.shape[0]
        lanes = torch.zeros((A, n_warps * 32, K_CHUNK), dtype=torch.int32,
                            device=dev).index_add_(1, lane_of,
                                                   mask.to(torch.int32))
        return (lanes > 0).view(A, n_warps, 32, K_CHUNK).sum(2)

    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        for j in range(int(nch[sl].max()) if n else 0):
            live = (nch[sl] > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            t = idx + g0
            rows = (first[t] + j * K_CHUNK)[:, None] + lane  # [A, K]
            buf = packed[rows]  # [A, K, D]
            g = _chunk_geometry(buf, px[t], py[t], rows, ends[t])
            valid, inr = g["valid"], g["in_range"]  # [A, P, K], [A, 1, K]
            w, m, _, t_new = _composite(g["alpha"], T[idx], cfg.cutoff)
            comp = valid if m is None else valid & m
            walked = inr.expand_as(valid)
            if m is None:
                seen = walked
            else:  # up to the first valid pair that is not composited
                stop = (valid & ~comp).to(torch.int32)
                seen = walked & ((torch.cumsum(stop, dim=-1) - stop) == 0)
            rx, ry, lm, _ = (v[:, None, :] for v in _pair_regions(
                [buf[..., r] for r in range(6)]))
            xs, ys = buf[:, None, :, 0], buf[:, None, :, 1]
            xlo, xhi, ylo, yhi = (v[t][:, :, None] for v in cells)
            ex = xs - torch.minimum(torch.maximum(xs, xlo), xhi)
            ey = ys - torch.minimum(torch.maximum(ys, ylo), yhi)
            box = (ex.abs() <= rx) & (ey.abs() <= ry) & inr  # [A, W, K]
            region = box[:, warp_of] & (g["sigma"] <= lm) & walked
            cand = region & seen
            counts["run"][t] += inr.sum((1, 2))
            counts["pairs"][t] += comp.any(1).sum(-1)
            counts["slots"][t] += comp.sum((1, 2))
            totals["evaluated_slots"] += seen.sum()
            totals["candidate_slots"] += cand.sum()
            totals["missed_slots"] += (valid & ~region).sum()
            totals["tested"] += (seen & valid).sum()
            totals["composited"] += comp.sum()
            totals["pair_warp_walked"] += n_warps * inr.sum()
            totals["pair_warp_cells"] += box.sum()
            totals["pair_warp_candidates"] += (by_warp(cand) > 0).sum()
            lanes_hit = by_warp(comp)
            totals["pair_warp_hits"] += (lanes_hit > 0).sum()
            totals["single_lane_hits"] += (lanes_hit == 1).sum()
            T[idx] = t_new
    longest = int(torch.argmax(counts["run"])) if nT else 0
    return dict(**counts, **{k: int(v) for k, v in totals.items()},
                longest_run=int(counts["run"][longest]) if nT else 0,
                longest_tile=longest, warps_per_tile=n_warps)


# ---------------------------------------------------------------------------
# The per-Gaussian reduction and the autograd function
# ---------------------------------------------------------------------------


def segment_reduce(v_packed, aligned_ids, exp_offsets, inv_perm, n_isects,
                   cfg: RasterCfg) -> torch.Tensor:
    """[cap2, D] per-row gradients -> [M, D] per-Gaussian sums, by
    ``cfg.segred`` (module docstring)."""
    M = cfg.m if cfg.m else exp_offsets.shape[0] - 1
    D = v_packed.shape[1]
    lo = exp_offsets[:-1].to(torch.int64)
    hi = exp_offsets[1:].to(torch.int64)
    ids = torch.where(aligned_ids >= 0, aligned_ids, M).to(torch.int64)
    if cfg.segred == "scatter":
        return v_packed.new_zeros((M + 1, D)).index_add_(0, ids,
                                                         v_packed)[:M]
    if cfg.segred == "sort":
        # id-sorted runs start at the expansion offsets: the expansion
        # enumerates Gaussians id-major with the same per-id counts
        rows = v_packed[torch.sort(ids, stable=True).indices]
    else:  # "cumsum"
        rows = v_packed[inv_perm.to(torch.int64)]
        pos = torch.arange(cfg.cap, device=v_packed.device)
        rows = torch.where((pos < n_isects)[:, None], rows,
                           torch.zeros((), device=v_packed.device))
    # the running sums along the rows of the transposed table (B10): a scan
    # over the outer dimension of [cap2, D] runs one thread per column
    cols = rows.t().contiguous()
    csum = torch.cat([cols.new_zeros((D, 1)), cumsum_rows(cols)], 1)
    return (csum[:, hi] - csum[:, lo]).t()


class _RasterizePacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, ordered, flat_attrs, aligned_ids, starts, ends,
                exp_offsets, inv_perm, n_isects):
        packed = _pack(flat_attrs, aligned_ids)
        # B7's and B8's tile order, where a backward follows
        runs = run_order(starts, ends) if ordered else None
        colors, alphas = raster_v1_fwd(packed, starts, ends, cfg, order=runs)
        ctx.cfg = cfg
        ctx.save_for_backward(packed, aligned_ids, starts, ends, colors,
                              alphas, exp_offsets, inv_perm, n_isects, runs)
        return colors, alphas

    @staticmethod
    def backward(ctx, v_colors, v_alphas):
        (packed, aligned_ids, starts, ends, colors, alphas, exp_offsets,
         inv_perm, n_isects, runs) = ctx.saved_tensors
        cfg = ctx.cfg
        v_packed = raster_v1_bwd(
            packed, starts, ends, colors, alphas,
            v_colors.to(torch.float32).contiguous(),
            v_alphas.to(torch.float32).contiguous(), cfg, order=runs)
        v_flat = segment_reduce(v_packed, aligned_ids, exp_offsets, inv_perm,
                                n_isects, cfg)
        return None, None, v_flat, None, None, None, None, None, None


def rasterize_to_pixels(
    means2d,  # [C, N, 2]
    conics,  # [C, N, 3]
    colors,  # [C, N, CH]
    opacities,  # [C, N]
    isect: Intersections,
    tile_offsets,  # unused (kept for the JAX signature)
    width: int,
    height: int,
    tile_size: int = 16,
    backgrounds=None,  # [C, CH]
    aligned: Optional[AlignedIsects] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable tile rasterization -> ([C,H,W,CH] colors, [C,H,W,1]
    alphas) over ``isect`` (ops/isect.isect_tiles). Gradients reach
    means2d, conics, colors, opacities and backgrounds. Runs where the
    tensors lie: B7 and B8 on a CUDA device, their plain versions on the
    CPU. CH <= 128 on a card (rendering.rasterization chunks wider
    renders)."""
    del tile_offsets
    if CUTOFF_MODE not in ("exact", "soft"):
        raise ValueError(f"unknown CUTOFF_MODE {CUTOFF_MODE!r}")
    if SEGRED_MODE not in SEGRED_MODES:
        raise ValueError(f"unknown SEGRED_MODE {SEGRED_MODE!r}")
    C, N, _ = means2d.shape
    CH = colors.shape[-1]
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    if aligned is None:
        aligned = align_isects(isect, C, TW, TH, K_CHUNK,
                               need_inv_perm=SEGRED_MODE == "cumsum")
    cfg = RasterCfg(C=C, tile_width=TW, tile_height=TH, tile_size=tile_size,
                    channels=CH, cap=isect.flatten_ids.shape[0],
                    cap2=aligned.ids.shape[0], m=C * N, cutoff=CUTOFF_MODE,
                    segred=SEGRED_MODE)
    flat_attrs = torch.cat([
        means2d.reshape(C * N, 2), conics.reshape(C * N, 3),
        opacities.reshape(C * N, 1), colors.reshape(C * N, CH),
    ], dim=-1).to(torch.float32)
    # longest run first where a backward follows: on trained views one
    # tile's run, ~10x the mean, sets B7's and B8's launches; a render with
    # no backward keeps index order, where the argsort costs more than it
    # saves (chip_smoke.py's scene_1m_v1 and train_v1 "order")
    ordered = torch.is_grad_enabled() and flat_attrs.requires_grad
    tile_colors, tile_alphas = _RasterizePacked.apply(
        cfg, ordered, flat_attrs, aligned.ids, aligned.starts, aligned.ends,
        isect.exp_offsets, aligned.inv_perm, aligned.n_isects)

    ts = tile_size

    def assemble(buf, ch):
        img = buf.reshape(C, TH, TW, ch, ts, ts).permute(0, 1, 4, 2, 5, 3)
        return img.reshape(C, TH * ts, TW * ts, ch)[:, :height, :width, :]

    img = assemble(tile_colors, CH)
    alp = assemble(tile_alphas, 1)
    if backgrounds is not None:
        img = img + (1.0 - alp) * backgrounds[:, None, None, :]
    return img, alp
