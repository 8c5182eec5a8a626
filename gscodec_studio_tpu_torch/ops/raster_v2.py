"""Fused tile rasterization, forward (port of
gscodec_studio_tpu/ops/raster_v2.py).

Pipeline, stage for stage as in the JAX package:
  1. per-Gaussian tile rectangles and counts (``tile_counts``);
  2. compaction-and-depth sort: one stable sort keyed by
     (visible ? depth : +inf); the pack kernel gathers the attribute rows
     into the compacted table in that order;
  3. expansion kernel: the fixed-capacity intersection list (tile key,
     attribute rows, compacted id), with the conservative ellipse cull to
     the overflow tile ``n_tiles``;
  4. one stable sort by tile key; the pack kernel gathers the sorted
     payload columns into the attr-major table ``S`` [n_attr + 1, cap];
  5. ``starts`` by a search of the sorted keys;
  6. tile-forward kernel: per-tile front-to-back compositing;
  7. tile-to-image assembly and backgrounds.

Each kernel wrapper (``pack_rows``, ``expand``, ``raster_fwd``) launches its
CUDA kernel for CUDA tensors and counts the launch in ``LAUNCHES``; for CPU
tensors it runs the plain PyTorch version beside it (``_pack_rows_plain``,
``_expand_plain``, ``_fwd_plain``), which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from gscodec_studio_tpu_torch import native
from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999

K = 128  # rows per chunk of the sorted table
# capacity granularity (the JAX package's EXPAND_B * EXPAND_SB)
CAP_BLOCK = 4096
INT32_MAX = 2**31 - 1
MAX_FWD_CHANNELS = 32  # the tile-forward kernel's register accumulators
MAX_PACK_ROWS = 128  # pack.cu kMaxRows

# Kernel launches since the last reset_launch_counts(), by wrapper.
LAUNCHES = {"pack_rows": 0, "expand": 0, "raster_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass(frozen=True)
class V2Cfg:
    C: int
    tile_width: int
    tile_height: int
    tile_size: int
    channels: int
    cap: int  # intersection capacity, a multiple of CAP_BLOCK
    n: int  # Gaussians per camera
    cutoff: str = "exact"  # or "soft": chunk-granular early termination

    @property
    def n_tiles(self) -> int:
        return self.C * self.tile_width * self.tile_height

    @property
    def n_tiles_v(self) -> int:
        # + the overflow tile that ellipse-culled pairs are keyed to
        return self.n_tiles + 1

    @property
    def pixels(self) -> int:
        return self.tile_size * self.tile_size

    @property
    def n_attr(self) -> int:
        # x, y, ca, cb, cc, op, colors[CH]
        return 6 + self.channels

    @property
    def d_s(self) -> int:
        # sorted table rows: attrs..., id
        return self.n_attr + 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device, contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# Binning: counts
# ---------------------------------------------------------------------------


def tile_counts(means2d, radii, tile_size, tile_width, tile_height):
    """Per-Gaussian tile-rectangle bounds and counts. ``radii`` is scalar
    per Gaussian ([..., N]) or per-axis AABB half-widths ([..., N, 2])."""
    dt = means2d.dtype
    tm = means2d / tile_size
    if radii.ndim == means2d.ndim:
        trx = radii[..., 0].to(dt) / tile_size
        try_ = radii[..., 1].to(dt) / tile_size
        alive = torch.maximum(radii[..., 0], radii[..., 1]) > 0
    else:
        trx = try_ = radii.to(dt) / tile_size
        alive = radii > 0
    i32 = torch.int32
    x0 = torch.clamp(torch.floor(tm[..., 0] - trx), 0, tile_width).to(i32)
    y0 = torch.clamp(torch.floor(tm[..., 1] - try_), 0, tile_height).to(i32)
    x1 = torch.clamp(torch.ceil(tm[..., 0] + trx), 0, tile_width).to(i32)
    y1 = torch.clamp(torch.ceil(tm[..., 1] + try_), 0, tile_height).to(i32)
    nx = x1 - x0
    counts = torch.where(alive, nx * (y1 - y0), torch.zeros_like(nx))
    return x0, y0, nx, counts


# ---------------------------------------------------------------------------
# B9a: pack rows (csrc/pack.cu)
# ---------------------------------------------------------------------------


def _pack_rows_plain(rows: Sequence[torch.Tensor], R: int,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    cols = [r if perm is None else r[perm] for r in rows]
    L = cols[0].shape[0]
    pad = [torch.zeros(L, dtype=torch.float32, device=cols[0].device)
           for _ in range(R - len(cols))]
    return torch.stack(cols + pad)


def pack_rows(rows: Sequence[torch.Tensor], R: int,
              perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n float32 rows [L_src] (each may be a strided view) -> [R, L] with
    rows >= n zero-filled; with ``perm`` (int64 [L]) column j is taken from
    position perm[j] of every row."""
    n = len(rows)
    if n == 0 or R < n:
        raise ValueError(f"pack_rows: {n} rows into {R}")
    L_src = rows[0].shape[0]
    for i, r in enumerate(rows):
        if r.ndim != 1 or r.shape[0] != L_src or r.dtype != torch.float32:
            raise ValueError(f"pack_rows: row {i} must be float32 [{L_src}]")
    if perm is not None and (perm.ndim != 1 or perm.dtype != torch.int64):
        raise ValueError("pack_rows: perm must be int64 [L]")
    if _on_cpu(rows[0], "pack_rows"):
        return _pack_rows_plain(rows, R, perm)
    dev = rows[0].device
    if n > MAX_PACK_ROWS:
        raise ValueError(f"pack_rows: at most {MAX_PACK_ROWS} rows on CUDA")
    for i, r in enumerate(rows):
        _check_cuda(f"pack_rows row {i}", r, torch.float32, dev,
                    contiguous=False)
    if perm is not None:
        _check_cuda("pack_rows perm", perm, torch.int64, dev)
    L = L_src if perm is None else perm.shape[0]
    out = torch.empty((R, L), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_uint64 * n)(*[r.data_ptr() for r in rows])
    strides = (ctypes.c_int * n)(*[r.stride(0) for r in rows])
    err = native.lib().gsc_pack_rows(
        ctypes.addressof(ptrs), ctypes.addressof(strides), n,
        None if perm is None else perm.data_ptr(), L, out.data_ptr(), R,
        _stream(),
    )
    native.check(err, "gsc_pack_rows")
    LAUNCHES["pack_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: expansion (csrc/expand.cu)
# ---------------------------------------------------------------------------


def _cull_lhs_rhs(cfg: V2Cfg, tile, table, g):
    """Both sides of the expansion's ellipse cull, keep = lhs <= rhs."""
    ts_f = float(cfg.tile_size)
    rem = tile % (cfg.tile_width * cfg.tile_height)
    txt = (rem % cfg.tile_width).to(torch.float32)
    tyt = torch.div(rem, cfg.tile_width, rounding_mode="floor").to(
        torch.float32)
    xs, ys, ca, cb, cc, op = (table[i][g] for i in range(6))
    qx = torch.minimum(torch.maximum(xs, txt * ts_f + 0.5),
                       txt * ts_f + ts_f - 0.5)
    qy = torch.minimum(torch.maximum(ys, tyt * ts_f + 0.5),
                       tyt * ts_f + ts_f - 0.5)
    ex = xs - qx
    ey = ys - qy
    d2 = ex * ex + ey * ey
    half_tr = 0.5 * (ca + cc)
    hd = 0.5 * (ca - cc)
    lam_min = torch.clamp(half_tr - torch.sqrt(hd * hd + cb * cb + 1e-30),
                          min=0.0)
    lhs = 0.5 * lam_min * d2
    rhs = torch.log(torch.clamp(255.0 * op, min=1e-12))
    return lhs, rhs


def _expand_plain(cum, base, nx, table, n_isects, cfg: V2Cfg):
    dev = cum.device
    cap = cfg.cap
    p = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = p < n_isects
    M = cum.shape[0]
    g = torch.clamp(torch.searchsorted(cum, p, right=True), max=M - 1)
    cum_e = torch.where(g > 0, cum[torch.clamp(g - 1, min=0)],
                        torch.zeros_like(cum[g]))
    rank = (p - cum_e).to(torch.float32)
    nxr = torch.clamp(nx[g].to(torch.float32), min=1.0)
    dy = torch.floor(rank / nxr)
    dx = rank - dy * nxr
    tile = (base[g].to(torch.float32) + dy * float(cfg.tile_width)
            + dx).to(torch.int32)
    lhs, rhs = _cull_lhs_rhs(cfg, tile, table, g)
    tile = torch.where(lhs <= rhs, tile, torch.full_like(tile, cfg.n_tiles))
    tile = torch.where(valid, tile, torch.full_like(tile, INT32_MAX))
    rows = torch.cat([table[:, g], g.to(torch.float32)[None]])
    rows = torch.where(valid[None], rows, torch.zeros((), device=dev))
    return tile, rows


def expand(cum, base, nx, table, n_isects, cfg: V2Cfg):
    """Compacted table -> (tile key int32 [cap], rows f32 [n_attr+1, cap]:
    the attribute rows then the compacted id). ``cum`` is the inclusive
    int32 count prefix clamped to the capacity, ``base``/``nx`` the int32
    first tile and rect width, ``table`` f32 [n_attr, M], ``n_isects`` an
    int32 [1] tensor (min(total, cap)). Rows >= n_isects get key
    INT32_MAX and zero rows."""
    M = cum.shape[0]
    if M < 1 or table.shape != (cfg.n_attr, M):
        raise ValueError(f"expand: table {tuple(table.shape)} for M={M}")
    if _on_cpu(cum, "expand"):
        return _expand_plain(cum, base, nx, table, n_isects, cfg)
    dev = cum.device
    for name, t, dt in (("cum", cum, torch.int32), ("base", base, torch.int32),
                        ("nx", nx, torch.int32),
                        ("table", table, torch.float32),
                        ("n_isects", n_isects, torch.int32)):
        _check_cuda(f"expand {name}", t, dt, dev)
    if base.shape != (M,) or nx.shape != (M,) or n_isects.numel() != 1:
        raise ValueError("expand: base/nx must be [M], n_isects one value")
    tile = torch.empty(cfg.cap, dtype=torch.int32, device=dev)
    rows = torch.empty((cfg.n_attr + 1, cfg.cap), dtype=torch.float32,
                       device=dev)
    err = native.lib().gsc_expand(
        cum.data_ptr(), M, base.data_ptr(), nx.data_ptr(), table.data_ptr(),
        cfg.n_attr, n_isects.data_ptr(), cfg.cap, cfg.tile_width,
        cfg.tile_height, cfg.tile_size, cfg.n_tiles, tile.data_ptr(),
        rows.data_ptr(), _stream(),
    )
    native.check(err, "gsc_expand")
    LAUNCHES["expand"] += 1
    return tile, rows


# ---------------------------------------------------------------------------
# Binning: compaction sort + expansion + tile sort
# ---------------------------------------------------------------------------


def _compact(cfg: V2Cfg, means2d, radii, depths):
    """Compaction-and-depth sort and the count prefix. Returns (order int64
    [M]: compacted position -> original index, cum int32 [M]: inclusive
    count prefix clamped to the capacity, base int32 [M]: first tile,
    nx int32 [M]: rect width >= 1, n_isects int32 [1]: min(total, cap))."""
    C, N = cfg.C, cfg.n
    M = C * N
    if M < 1:
        raise ValueError("rasterize_to_pixels_v2 needs at least one Gaussian")
    if M >= 1 << 24:
        raise ValueError("compacted ids are exact in f32 only for C*N < 2^24")
    TW, TH, ts = cfg.tile_width, cfg.tile_height, cfg.tile_size

    _, _, _, counts_pre = tile_counts(means2d, radii, ts, TW, TH)
    visible = counts_pre.reshape(M) > 0
    depth_key = torch.where(visible, depths.reshape(M),
                            torch.full((), math.inf, device=depths.device))
    order = torch.sort(depth_key, stable=True).indices

    ell = radii.ndim == means2d.ndim
    m2d_s = means2d.reshape(M, 2)[order]
    radius_s = (radii.reshape(M, 2) if ell else radii.reshape(M))[order]
    x0s, y0s, nxs, counts_s = tile_counts(m2d_s, radius_s, ts, TW, TH)
    base_s = (torch.div(order, N, rounding_mode="floor") * (TW * TH)
              + y0s * TW + x0s).to(torch.int32)
    cum = torch.cumsum(counts_s, 0)
    n_isects = torch.clamp(cum[-1:], max=cfg.cap).to(torch.int32)
    cum_cl = torch.clamp(cum, max=cfg.cap).to(torch.int32)
    return order, cum_cl, base_s, torch.clamp(nxs, min=1), n_isects


def _attr_rows(cfg: V2Cfg, means2d, conics, colors, opacities):
    """The n_attr per-Gaussian rows (x, y, ca, cb, cc, op, colors[CH]) as
    strided views of the contiguous inputs."""
    M = cfg.C * cfg.n
    m2 = means2d.reshape(M, 2)
    c3 = conics.reshape(M, 3)
    cf = colors.reshape(M, cfg.channels)
    return ([m2[:, 0], m2[:, 1], c3[:, 0], c3[:, 1], c3[:, 2],
             opacities.reshape(M)]
            + [cf[:, i] for i in range(cfg.channels)])


class Binning(NamedTuple):
    """The sorted intersection table and every stage's output on the way."""

    S: torch.Tensor  # [d_s, cap]: x, y, ca, cb, cc, op, colors[CH], id
    starts: torch.Tensor  # int32 [n_tiles + 2]: each tile's first row
    n_isects: torch.Tensor  # int32 [1]: min(total, cap)
    order: torch.Tensor  # int64 [M]: compacted position -> original index
    cum: torch.Tensor  # int32 [M]: inclusive count prefix, clamped to cap
    base: torch.Tensor  # int32 [M]: first tile of each rect
    nx: torch.Tensor  # int32 [M]: rect width in tiles (>= 1)
    table: torch.Tensor  # [n_attr, M]: the compacted attribute rows
    tile: torch.Tensor  # int32 [cap]: the expansion's tile keys
    rows: torch.Tensor  # [d_s, cap]: the expansion's rows, unsorted
    perm: torch.Tensor  # int64 [cap]: the stable tile order


def _build_sorted(cfg: V2Cfg, means2d, conics, colors, opacities, depths,
                  radii) -> Binning:
    """Compaction sort, pack, expansion, tile sort, pack, starts. S's
    columns >= n_isects are zero."""
    order, cum, base, nx, n_isects = _compact(cfg, means2d, radii, depths)
    table = pack_rows(_attr_rows(cfg, means2d, conics, colors, opacities),
                      cfg.n_attr, perm=order)
    tile, rows = expand(cum, base, nx, table, n_isects, cfg)
    tile_sorted, perm = torch.sort(tile, stable=True)
    S = pack_rows(list(rows), cfg.d_s, perm=perm)
    starts = torch.searchsorted(
        tile_sorted,
        torch.arange(cfg.n_tiles_v + 1, dtype=torch.int32,
                     device=tile.device),
    ).to(torch.int32)
    return Binning(S, starts, n_isects, order, cum, base, nx, table, tile,
                   rows, perm)


# ---------------------------------------------------------------------------
# B1: tile forward (csrc/raster_fwd.cu)
# ---------------------------------------------------------------------------


def _composite(alpha, t_cur, cutoff):
    """Front-to-back weights of one chunk. alpha [..., P, K], t_cur
    [..., P, 1] -> (w, t_new). "exact": a pixel takes the pairs before the
    first one whose inclusive product falls to <= 1e-4; "soft": no mask."""
    oma = 1.0 - alpha
    excl = torch.cumprod(
        torch.cat([torch.ones_like(oma[..., :1]), oma[..., :-1]], dim=-1),
        dim=-1,
    )
    t_prev = excl * t_cur
    if cutoff == "soft":
        return alpha * t_prev, t_prev[..., -1:] * oma[..., -1:]
    t_incl = t_prev * oma
    m = t_incl > TRANSMITTANCE_EPS
    w = alpha * t_prev * m.to(alpha.dtype)
    t_new = torch.where(m, t_incl, t_cur.expand_as(t_incl)).amin(
        dim=-1, keepdim=True)
    return w, torch.minimum(t_cur, t_new)


def _fwd_plain(S, starts, masks, cfg: V2Cfg, with_counts: bool = False):
    """Plain version of the tile-forward kernel: loops over the chunk index
    and vectorises across tiles, a group of tiles at a time (2^20 tile
    pixels on a card, 2^16 on the CPU).

    With ``with_counts`` it returns (out, counts), where counts holds what
    the kernel does on these inputs, per (pair, pixel): "evaluated" pairs
    whose sigma and alpha are computed (in exact mode the pairs up to and
    including the one that ends the pixel's chunk), "tested" pairs that
    pass the alpha test and reach the transmittance step, and "composited"
    pairs that add to the colors."""
    dev = S.device
    nT, P, ts, CH = cfg.n_tiles, cfg.pixels, cfg.tile_size, cfg.channels
    TW = cfg.tile_width
    st = starts.to(torch.int64)
    off, end = st[:nT], st[1:nT + 1]
    c0 = torch.div(off, K, rounding_mode="floor")
    c1 = torch.where((end > off) & (masks > 0),
                     torch.div(end + K - 1, K, rounding_mode="floor"), c0)
    rem = torch.arange(nT, device=dev) % (TW * cfg.tile_height)
    p = torch.arange(P, device=dev)
    px = ((rem % TW)[:, None] * ts + p % ts).to(torch.float32) + 0.5
    py = (torch.div(rem, TW, rounding_mode="floor")[:, None] * ts
          + torch.div(p, ts, rounding_mode="floor")).to(torch.float32) + 0.5
    lane = torch.arange(K, device=dev)
    out = torch.empty((nT, P, CH + 1), dtype=torch.float32, device=dev)
    group = max(1, (1 << 20 if S.is_cuda else 1 << 16) // P)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("evaluated", "tested", "composited")}
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((n, P, CH), dtype=torch.float32, device=dev)
        nch = c1[sl] - c0[sl]
        for j in range(int(nch.max()) if n else 0):
            live = nch > j
            if cfg.cutoff == "soft":
                live &= T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            chunk = S[:, cols]  # [d_s, A, K]
            xs, ys, ca, cb, cc, op = (chunk[i][:, None, :] for i in range(6))
            dx = xs - px[sl][idx][:, :, None]  # [A, P, K]
            dy = ys - py[sl][idx][:, :, None]
            sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
                     + cb * (dx * dy))
            inr = ((cols >= off[sl][idx, None])
                   & (cols < end[sl][idx, None]))[:, None, :]
            alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
            valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & inr
            alpha = torch.where(valid, alpha, torch.zeros((), device=dev))
            w, t_new = _composite(alpha, T[idx], cfg.cutoff)
            acc[idx] += torch.einsum("apk,cak->apc", w, chunk[6:6 + CH])
            T[idx] = t_new
            if with_counts:
                if cfg.cutoff == "soft":
                    comp, seen = valid, inr.expand_as(valid)
                else:  # up to the first valid pair that is not composited
                    comp = w > 0.0  # a composited pair has alpha, T > 0
                    stop = (valid & ~comp).to(torch.int32)
                    seen = inr & ((torch.cumsum(stop, dim=-1) - stop) == 0)
                counts["evaluated"] += seen.sum()
                counts["tested"] += (seen & valid).sum()
                counts["composited"] += comp.sum()
        out[sl, :, :CH] = acc
        out[sl, :, CH] = 1.0 - T[..., 0]
    if with_counts:
        return out, {k: int(v) for k, v in counts.items()}
    return out


def raster_fwd(S, starts, masks, cfg: V2Cfg):
    """Sorted table -> per-tile outputs [n_tiles, P, CH+1] (colors, then
    alpha = 1 - T_final). ``masks`` int32 [n_tiles], 0 disables a tile."""
    if S.shape != (cfg.d_s, cfg.cap) or starts.shape != (cfg.n_tiles_v + 1,) \
            or masks.shape != (cfg.n_tiles,):
        raise ValueError("raster_fwd: S, starts or masks has the wrong shape")
    if cfg.cutoff not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff {cfg.cutoff!r}")
    if _on_cpu(S, "raster_fwd"):
        return _fwd_plain(S, starts, masks, cfg)
    dev = S.device
    if cfg.channels > MAX_FWD_CHANNELS:
        raise NotImplementedError(
            f"the tile-forward kernel takes at most {MAX_FWD_CHANNELS} "
            f"channels, got {cfg.channels}")
    if cfg.pixels > 1024:
        raise ValueError("tile_size above 32 does not fit one CUDA block")
    _check_cuda("raster_fwd S", S, torch.float32, dev)
    _check_cuda("raster_fwd starts", starts, torch.int32, dev)
    _check_cuda("raster_fwd masks", masks, torch.int32, dev)
    out = torch.empty((cfg.n_tiles, cfg.pixels, cfg.channels + 1),
                      dtype=torch.float32, device=dev)
    err = native.lib().gsc_raster_fwd(
        S.data_ptr(), cfg.cap, starts.data_ptr(), masks.data_ptr(),
        cfg.n_tiles, cfg.tile_width, cfg.tile_height, cfg.tile_size,
        cfg.channels, int(cfg.cutoff == "soft"), out.data_ptr(), _stream(),
    )
    native.check(err, "gsc_raster_fwd")
    LAUNCHES["raster_fwd"] += 1
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class _RasterCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, means2d, conics, colors, opacities, depths, radii,
                masks):
        b = _build_sorted(cfg, means2d, conics, colors, opacities, depths,
                          radii)
        tiles = raster_fwd(b.S, b.starts, masks, cfg)
        ctx.mark_non_differentiable(b.n_isects)
        return tiles, b.n_isects

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "rasterize_to_pixels_v2 has no backward yet: its backward "
            "kernels come with the port's training slice"
        )


def rasterize_to_pixels_v2(
    means2d,  # [C, N, 2]
    conics,  # [C, N, 3]
    colors,  # [C, N, CH]
    opacities,  # [C, N]
    depths,  # [C, N]
    radii,  # [C, N] or [C, N, 2] int32
    width: int,
    height: int,
    tile_size: int = 16,
    isect_capacity: int = 1 << 20,
    backgrounds=None,  # [C, CH]
    masks=None,  # [C, TH, TW] bool
    absgrad_probe=None,
    cutoff_mode: str = "exact",
    grad_dtype: str = "f32",
    attr_dtype: str = "f32",
    log_composite: bool = False,
    geom_dtype: str = "f32",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Fused binning + tile rasterization, forward.

    Returns ([C,H,W,CH] colors, [C,H,W,1] alphas, meta) with
    meta["n_isects"] = min(total intersections, capacity) as an int32 [1]
    tensor. The capacity is ``isect_capacity`` rounded up to a multiple of
    4096, as in the JAX package."""
    if absgrad_probe is not None:
        raise NotImplementedError("absgrad_probe is not ported yet")
    if grad_dtype != "f32" or attr_dtype != "f32" or geom_dtype != "f32":
        raise NotImplementedError("only f32 grad/attr/geom rows are ported")
    if log_composite:
        raise NotImplementedError("log_composite is not ported yet")
    if cutoff_mode not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff_mode {cutoff_mode!r}")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    means2d, conics, colors = f32(means2d), f32(conics), f32(colors)
    opacities, depths = f32(opacities), f32(depths)
    radii = torch.as_tensor(radii, device=dev).to(torch.int32).contiguous()
    C, N, _ = means2d.shape
    CH = colors.shape[-1]
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    cap = -(-isect_capacity // CAP_BLOCK) * CAP_BLOCK
    cfg = V2Cfg(C=C, tile_width=TW, tile_height=TH, tile_size=tile_size,
                channels=CH, cap=cap, n=N, cutoff=cutoff_mode)
    if masks is None:
        masks_arr = torch.ones(cfg.n_tiles, dtype=torch.int32, device=dev)
    else:
        masks_arr = torch.as_tensor(masks, device=dev).reshape(
            cfg.n_tiles).to(torch.int32)
    tiles, n_isects = _RasterCore.apply(
        cfg, means2d, conics, colors, opacities, depths, radii, masks_arr
    )

    ts = tile_size
    img = tiles.reshape(C, TH, TW, ts, ts, CH + 1).permute(0, 1, 3, 2, 4, 5)
    img = img.reshape(C, TH * ts, TW * ts, CH + 1)[:, :height, :width, :]
    colors_img = img[..., :CH]
    alphas = img[..., CH:CH + 1]
    if backgrounds is not None:
        colors_img = colors_img + (1.0 - alphas) * f32(backgrounds)[
            :, None, None, :]
    meta = {"n_isects": n_isects, "tile_width": TW, "tile_height": TH}
    return colors_img, alphas, meta
