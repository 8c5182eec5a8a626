"""Fused tile rasterization, forward and backward (port of
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

Backward (``_RasterCore.backward``):
  8. tile-backward kernel: per-tile front-to-back recompute, writing each
     in-range intersection's gradient rows at its own column of S;
  9. unpack kernel scattering through the tile order: the rows back in
     expansion order, where compacted id r owns [cum[r-1], cum[r]);
 10. segment-sum kernel over those ranges: per-Gaussian sums;
 11. unpack kernel scattering through the depth order: original order.

With ``grad_dtype="bf16"`` the gradient rows travel as packed pairs, as in
the JAX package: step 8 stores each two values of an intersection as one
32-bit word (truncated-bf16 high half, truncated-bf16 low half), step 9
moves the words, step 10 sums the high and the low halves apart in f32,
and the per-Gaussian sums are truncated to pairs again for step 11. The
values that reach autograd are truncated bf16.

The sorted table's precision knobs, as in the JAX package (3DGS layout
only for the first two): ``attr_dtype="bf16"`` stores the values after the
position, (ca, cb), (cc, op), (c0, c1), ..., as packed pairs of truncated
bf16; ``geom_dtype="u16"`` stores (x, y) as one word of 1/8-px fixed point
over [-4096, 4096) px, clipped outside; ``log_composite`` evaluates the
transmittance scan in log space (``_composite_log``). The expansion writes
the packed rows from the f32 table (its cull reads the f32 values), S
carries the words in its float32 rows, which only copies and integer
operations touch, and B1 and B2 unpack them. The gradients are those of the
unpacked values, and reach the f32 inputs as they are.

Each kernel wrapper (``pack_rows``, ``expand``, ``raster_fwd``,
``raster_bwd``, ``unpack_rows``, ``segsum_rows``, and ``cumsum_rows``, the
JAX package's streaming row cumsum, which the port's v1 reduction calls)
launches its CUDA kernel for CUDA tensors and counts the launch in
``LAUNCHES``; for CPU
tensors it runs the plain PyTorch version beside it (``_pack_rows_plain``,
``_expand_plain``, ``_fwd_plain``, ``_bwd_plain``, ``_unpack_rows_plain``,
``_segsum_plain``, ``torch.cumsum``), which the tests hold against the JAX
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
MAX_CHANNELS = 128  # the tile kernels' largest channel instantiation
MAX_PACK_ROWS = 144  # pack.cu kMaxRows
EXPAND_ROWS_PER_BLOCK = 512  # expand.cu BR: B3's output rows a block

# Kernel launches since the last reset_launch_counts(), by wrapper and
# branch (the wrappers of raster_v2_2dgs, rasterize_pallas and
# profiling/kernel_skel_bench count here too, and so does
# optimizers/selective_adam, whose kernel is no raster kernel).
# A launch counts once under each branch key it takes: "_packed" for the
# packed-pair gradient rows of raster_bwd and segsum_rows and for the packed
# rows that expand writes, "_unpack" for tile kernels reading packed rows,
# "_log" for the log-space scan, "_absgrad" for the 2DGS backward's absgrad
# rows; a launch that takes none counts under the wrapper's own name.
LAUNCHES = {"pack_rows": 0, "expand": 0, "raster_fwd": 0, "raster_bwd": 0,
            "unpack_rows": 0, "segsum_rows": 0, "raster_fwd_2dgs": 0,
            "raster_bwd_2dgs": 0, "raster_bwd_packed": 0,
            "segsum_rows_packed": 0, "expand_packed": 0,
            "raster_fwd_unpack": 0, "raster_fwd_log": 0,
            "raster_bwd_unpack": 0, "raster_bwd_log": 0,
            "raster_fwd_2dgs_log": 0, "raster_bwd_2dgs_log": 0,
            "raster_bwd_2dgs_absgrad": 0, "raster_v1_fwd": 0,
            "raster_v1_bwd": 0, "cumsum_rows": 0, "skel_composite": 0,
            "selective_adam": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_keys(name: str, branches: Sequence[Tuple[bool, str]]):
    """The LAUNCHES keys that one launch of ``name``'s kernel counts under:
    name + suffix for each (taken, suffix) branch it takes, or name if it
    takes none."""
    return [name + sfx for taken, sfx in branches if taken] or [name]


def _count_launch(name: str, branches: Sequence[Tuple[bool, str]]) -> None:
    for key in launch_keys(name, branches):
        LAUNCHES[key] += 1


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
    # The skeleton's generic geometry (the 2DGS kernels share it): attribute
    # rows per Gaussian before the id row (0 means the 3DGS layout, 6 + CH),
    # whether the expansion ellipse-culls (it reads the 3DGS conic layout x,
    # y, ca, cb, cc, op at rows 0-5), and per-pixel outputs beyond the
    # channels and alpha.
    n_attr: int = 0
    cull: bool = True
    extra_out: int = 0
    # The sorted table's precision (module docstring): "bf16" attribute
    # pairs and the "u16" position word hold for the 3DGS layout only
    # (n_attr == 0); the log-space scan for every layout.
    attr_dtype: str = "f32"
    geom_dtype: str = "f32"
    log_composite: bool = False
    # the 2DGS backward's two |means2d| rows (raster_v2_2dgs.cfg_2dgs); the
    # 3DGS raster_bwd takes absgrad as an argument
    absgrad: bool = False

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
    def n_attr_eff(self) -> int:
        # 3DGS: x, y, ca, cb, cc, op, colors[CH]
        return self.n_attr or (6 + self.channels)

    @property
    def attr_packed(self) -> bool:
        return self.attr_dtype == "bf16" and self.n_attr == 0

    @property
    def geom_packed(self) -> bool:
        return self.geom_dtype == "u16" and self.n_attr == 0

    @property
    def n_geom_rows(self) -> int:
        # (x, y) as two f32 rows, or one u16 position word
        return 1 if self.geom_packed else 2

    @property
    def n_srows(self) -> int:
        # sorted rows before the id: the position, then ca, cb, cc, op,
        # colors[CH] (as pairs when attr_packed; an odd last with 0)
        if self.attr_packed:
            return self.n_geom_rows + (4 + self.channels + 1) // 2
        if self.geom_packed:
            return self.n_geom_rows + 4 + self.channels
        return self.n_attr_eff

    @property
    def idrow(self) -> int:
        return self.n_srows

    @property
    def d_s(self) -> int:
        # sorted table rows: attrs..., id
        return self.n_srows + 1

    def d_g(self, absgrad: bool) -> int:
        # gradient rows: one per attribute row (, |x|, |y|)
        return self.n_attr_eff + (2 if absgrad else 0)

    @property
    def n_vpairs(self) -> int:
        # packed rows of the attribute gradients (an odd last pairs with 0)
        return (self.n_attr_eff + 1) // 2

    def d_gp(self, absgrad: bool) -> int:
        # packed gradient rows: the value pairs (, one (|x|, |y|) pair)
        return self.n_vpairs + (1 if absgrad else 0)

    @property
    def chp(self) -> int:
        # per-pixel tile outputs: channels, alpha, extras
        return self.channels + 1 + self.extra_out


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
    words = [r.view(torch.int32) for r in rows]  # packed words keep bits
    cols = [w if perm is None else w[perm] for w in words]
    L = cols[0].shape[0]
    pad = [torch.zeros(L, dtype=torch.int32, device=cols[0].device)
           for _ in range(R - len(cols))]
    return torch.stack(cols + pad).view(torch.float32)


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
    if max(L_src, 0 if perm is None else perm.shape[0]) >= 1 << 31:
        raise ValueError("pack_rows: at most 2^31 - 1 columns on CUDA")
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
    if cfg.cull:
        lhs, rhs = _cull_lhs_rhs(cfg, tile, table, g)
        tile = torch.where(lhs <= rhs, tile,
                           torch.full_like(tile, cfg.n_tiles))
    tile = torch.where(valid, tile, torch.full_like(tile, INT32_MAX))
    words = torch.cat([_sorted_words(cfg, table[:, g]),
                       g.to(torch.float32).view(torch.int32)[None]])
    words = torch.where(valid[None], words, torch.zeros((), dtype=torch.int32,
                                                        device=dev))
    return tile, words.view(torch.float32)


def _sorted_words(cfg: V2Cfg, vals: torch.Tensor) -> torch.Tensor:
    """The attribute values f32 [n_attr, L] -> the sorted table's rows
    before the id, int32 words [n_srows, L]: the f32 bits, or with
    geom_packed one u16 position word and with attr_packed the values after
    the position as truncated-bf16 pairs, an odd last with 0."""
    if not (cfg.geom_packed or cfg.attr_packed):
        return vals.view(torch.int32)
    rows = ([pack_u16_xy(vals[0], vals[1])[None]] if cfg.geom_packed
            else [vals[:2].view(torch.int32)])
    rest = vals[2:]
    if cfg.attr_packed:
        n = rest.shape[0]
        rows += [pack_pairs(rest[i], rest[i + 1] if i + 1 < n
                            else torch.zeros_like(rest[i]))[None]
                 for i in range(0, n, 2)]
    else:
        rows.append(rest.view(torch.int32))
    return torch.cat(rows)


def expand(cum, base, nx, table, n_isects, cfg: V2Cfg):
    """Compacted table -> (tile key int32 [cap], rows f32 [d_s, cap]: the
    attribute rows, packed as cfg says (_sorted_words), then the compacted
    id). ``cum`` is the inclusive int32 count prefix clamped to the
    capacity, ``base``/``nx`` the int32 first tile and rect width,
    ``table`` f32 [n_attr, M], ``n_isects`` an int32 [1] tensor
    (min(total, cap)). Rows >= n_isects get key
    INT32_MAX and zero rows. With ``cfg.cull`` a pair whose conic ellipse
    misses its tile (rows 0-5 read as x, y, ca, cb, cc, op) is keyed to the
    overflow tile n_tiles; without it every in-range pair keeps its tile."""
    M = cum.shape[0]
    if M < 1 or table.shape != (cfg.n_attr_eff, M):
        raise ValueError(f"expand: table {tuple(table.shape)} for M={M}")
    if cfg.cull and cfg.n_attr_eff < 6:
        raise ValueError("expand: the ellipse cull reads 6 attribute rows")
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
    rows = torch.empty((cfg.d_s, cfg.cap), dtype=torch.float32, device=dev)
    err = native.lib().gsc_expand(
        cum.data_ptr(), M, base.data_ptr(), nx.data_ptr(), table.data_ptr(),
        cfg.n_attr_eff, n_isects.data_ptr(), cfg.cap, cfg.tile_width,
        cfg.tile_height, cfg.tile_size, cfg.n_tiles, int(cfg.cull),
        int(cfg.geom_packed), int(cfg.attr_packed), tile.data_ptr(), rows.data_ptr(), _stream(),
    )
    native.check(err, "gsc_expand")
    _count_launch("expand", [(cfg.geom_packed or cfg.attr_packed,
                              "_packed")])
    return tile, rows


def expand_gaussians(cum, n_isects) -> int:
    """The Gaussians whose rows lie below n_isects, which are all that B3
    reads: [0, g] for g the Gaussian of row n_isects - 1 (every Gaussian
    before it has a row; the invisible ones, count 0, sort last, and those
    past the capacity have none)."""
    n = int(n_isects.reshape(-1)[0])
    if n <= 0:
        return 0
    last = torch.tensor([n - 1], dtype=torch.int64, device=cum.device)
    g = torch.searchsorted(cum.to(torch.int64), last, right=True)
    return min(int(g[0]), cum.shape[0] - 1) + 1


def expand_counts(cum, n_isects, cfg: V2Cfg,
                  rows_per_block: Optional[int] = None, tile=None) -> dict:
    """B3's work on these inputs, in its layout (csrc/expand.cu): blocks of
    ``rows_per_block`` output rows (default EXPAND_ROWS_PER_BLOCK). Counts
    the rows below n_isects and the tail rows past it, the Gaussians those
    rows read (expand_gaussians), the blocks with a row in range and those
    wholly past it, each live block's window of Gaussians (its first to its
    last in-range row's; mean, p99, max) and the windows wider than the
    block (which the kernel reads from device memory), and the longest run
    (one Gaussian's rows, its tiles). With ``tile`` (the expansion's keys)
    also the culled pairs, those keyed to the overflow tile."""
    rpb = rows_per_block or EXPAND_ROWS_PER_BLOCK
    n = int(n_isects.reshape(-1)[0])
    cap, M = cfg.cap, cum.shape[0]
    c64 = cum.to(torch.int64)
    blocks = -(-cap // rpb)
    first = torch.arange(0, min(n, cap), rpb, device=cum.device)
    last = torch.clamp(first + rpb, max=n) - 1
    g0 = torch.clamp(torch.searchsorted(c64, first, right=True), max=M - 1)
    g1 = torch.clamp(torch.searchsorted(c64, last, right=True), max=M - 1)
    window = (g1 - g0 + 1).double()
    runs = torch.diff(c64, prepend=c64.new_zeros(1))
    out = dict(rows_per_block=rpb, rows=n, tail_rows=cap - n,
               gaussians=expand_gaussians(cum, n_isects), blocks=blocks,
               live_blocks=int(first.numel()),
               tail_blocks=blocks - int(first.numel()),
               window=dict(mean=float(window.mean()) if n else 0.0,
                           p99=float(torch.quantile(window, 0.99)) if n
                           else 0.0,
                           max=int(window.max()) if n else 0),
               wide_windows=int((window > rpb).sum()),
               longest_run=int(runs.max()))
    if tile is not None:
        out["culled"] = int((tile[:n] == cfg.n_tiles).sum())
    return out


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
    """The 3DGS layout's per-Gaussian rows (x, y, ca, cb, cc, op,
    colors[CH]) as strided views of the contiguous inputs."""
    M = cfg.C * cfg.n
    m2 = means2d.reshape(M, 2)
    c3 = conics.reshape(M, 3)
    cf = colors.reshape(M, cfg.channels)
    return ([m2[:, 0], m2[:, 1], c3[:, 0], c3[:, 1], c3[:, 2],
             opacities.reshape(M)]
            + [cf[:, i] for i in range(cfg.channels)])


class Binning(NamedTuple):
    """The sorted intersection table and every stage's output on the way."""

    S: torch.Tensor  # [d_s, cap]: the attribute rows (words), then the id
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
    """The 3DGS attribute layout through the generic build."""
    return _build_sorted_generic(
        cfg, means2d, _attr_rows(cfg, means2d, conics, colors, opacities),
        depths, radii)


def _build_sorted_generic(cfg: V2Cfg, means2d, attr_rows, depths,
                          radii) -> Binning:
    """Compaction sort, pack, expansion, tile sort, pack, starts, for the
    cfg.n_attr_eff per-Gaussian f32 rows ``attr_rows`` (each [C*N], may be
    a strided view; the first two are x, y, and with cfg.cull rows 0-5 are
    the 3DGS conic layout). S's columns >= n_isects are zero; its packed
    rows (cfg.geom_packed, cfg.attr_packed) hold int32 words."""
    if len(attr_rows) != cfg.n_attr_eff:
        raise ValueError(f"{len(attr_rows)} attribute rows, expected "
                         f"{cfg.n_attr_eff}")
    order, cum, base, nx, n_isects = _compact(cfg, means2d, radii, depths)
    table = pack_rows(attr_rows, cfg.n_attr_eff, perm=order)
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


def _composite(alpha, t_cur, cutoff, log: bool = False):
    """Front-to-back weights of one chunk. alpha [..., P, K] (0 for pairs
    that fail the tests), t_cur [..., P, 1] -> (w, m, t_prev, t_new); m is
    None for the soft cutoff. "exact": a pixel takes the pairs before the
    first one whose inclusive transmittance falls to <= 1e-4; "soft": no
    mask. ``log`` selects the log-space scan (_composite_log)."""
    if log:
        return _composite_log(alpha, t_cur, cutoff)
    oma = 1.0 - alpha
    excl = torch.cumprod(
        torch.cat([torch.ones_like(oma[..., :1]), oma[..., :-1]], dim=-1),
        dim=-1,
    )
    t_prev = excl * t_cur
    if cutoff == "soft":
        return alpha * t_prev, None, t_prev, t_prev[..., -1:] * oma[..., -1:]
    t_incl = t_prev * oma
    m = t_incl > TRANSMITTANCE_EPS
    w = alpha * t_prev * m.to(alpha.dtype)
    t_new = torch.where(m, t_incl, t_cur.expand_as(t_incl)).amin(
        dim=-1, keepdim=True)
    return w, m, t_prev, torch.minimum(t_cur, t_new)


def _log_split(alpha):
    """l = log1p(-alpha) and its two bf16 halves (rounded to nearest even,
    as the JAX package's astype(bfloat16)), the halves as f32."""
    l = torch.log1p(-alpha)
    l1 = l.to(torch.bfloat16).to(torch.float32)
    l2 = (l - l1).to(torch.bfloat16).to(torch.float32)
    return l, l1, l2


def _composite_log(alpha, t_cur, cutoff):
    """_composite in log space (the JAX package's _composite_log): incl is
    the running sum of the l1 halves plus the running sum of the l2 halves
    (two sums, not the sum of l1 + l2), excl = incl - l with the f32 l,
    T_prev = T * exp(excl); the exact mask is T * exp(incl) > 1e-4, the
    soft cutoff ends the chunk at T * exp(incl[K-1]). The two sums run pair
    after pair in f32, as the kernels walk them, so T_prev has their bits
    where exp and log1p agree (the JAX package sums by a matmul, in an
    order of its own)."""
    l, l1, l2 = _log_split(alpha)
    s1 = torch.zeros_like(l1[..., 0])
    s2 = torch.zeros_like(s1)
    incl = torch.empty_like(l)
    for k in range(l.shape[-1]):
        s1 = s1 + l1[..., k]
        s2 = s2 + l2[..., k]
        incl[..., k] = s1 + s2
    t_prev = t_cur * torch.exp(incl - l)
    if cutoff == "soft":
        return alpha * t_prev, None, t_prev, t_cur * torch.exp(incl[..., -1:])
    t_incl = t_cur * torch.exp(incl)
    m = t_incl > TRANSMITTANCE_EPS
    w = alpha * t_prev * m.to(alpha.dtype)
    t_new = torch.where(m, t_incl, t_cur.expand_as(t_incl)).amin(
        dim=-1, keepdim=True)
    return w, m, t_prev, torch.minimum(t_cur, t_new)


def _chunk_values(cfg: V2Cfg, chunk):
    """The f32 values of a chunk [d_s, ...] of the 3DGS sorted table:
    ([x, y, ca, cb, cc, op], colors [CH, ...]), the packed rows unpacked
    (the JAX package's _chunk_pair and _chunk_colors readers)."""
    ng, CH = cfg.n_geom_rows, cfg.channels
    xy = (list(unpack_u16_xy(chunk[0].view(torch.int32))) if cfg.geom_packed
          else [chunk[0], chunk[1]])
    if not cfg.attr_packed:
        return ([*xy, *(chunk[ng + i] for i in range(4))],
                chunk[ng + 4:ng + 4 + CH])
    vals = []
    for r in range(ng, cfg.n_srows):
        vals += unpack_pairs(chunk[r].view(torch.int32))
    return xy + vals[:4], torch.stack(vals[4:4 + CH])


class _TileWalk(NamedTuple):
    """What the plain tile walks share: each tile's run [off, end), its
    chunk range [c0, c1) (empty for a masked tile), its pixel centres
    [n_tiles, P], the lane offsets of a chunk, and how many tiles to
    vectorise at a time (2^20 tile pixels on a card, 2^16 on the CPU)."""

    off: torch.Tensor
    end: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    lane: torch.Tensor
    group: int


def _tile_walk(S, starts, masks, cfg: V2Cfg) -> _TileWalk:
    dev = S.device
    nT, P, ts, TW = cfg.n_tiles, cfg.pixels, cfg.tile_size, cfg.tile_width
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
    group = max(1, (1 << 20 if S.is_cuda else 1 << 16) // P)
    return _TileWalk(off, end, c0, c1, px, py, torch.arange(K, device=dev),
                     group)


def _fwd_plain(S, starts, masks, cfg: V2Cfg, with_counts: bool = False):
    """Plain version of the tile-forward kernel: loops over the chunk index
    and vectorises across tiles, a group of tiles at a time (_tile_walk).

    With ``with_counts`` it returns (out, counts), where counts holds what
    the kernel does on these inputs, per (pair, pixel): "evaluated" pairs
    whose sigma and alpha are computed (in exact mode the pairs up to and
    including the one that ends the pixel's chunk), "tested" pairs that
    pass the alpha test and reach the transmittance step, and "composited"
    pairs that add to the colors."""
    dev = S.device
    nT, P, CH = cfg.n_tiles, cfg.pixels, cfg.channels
    off, end, c0, c1, px, py, lane, group = _tile_walk(S, starts, masks, cfg)
    out = torch.empty((nT, P, CH + 1), dtype=torch.float32, device=dev)
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
            geo, colors = _chunk_values(cfg, chunk)
            xs, ys, ca, cb, cc, op = (v[:, None, :] for v in geo)
            dx = xs - px[sl][idx][:, :, None]  # [A, P, K]
            dy = ys - py[sl][idx][:, :, None]
            sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
                     + cb * (dx * dy))
            inr = ((cols >= off[sl][idx, None])
                   & (cols < end[sl][idx, None]))[:, None, :]
            alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
            valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & inr
            alpha = torch.where(valid, alpha, torch.zeros((), device=dev))
            w, _, _, t_new = _composite(alpha, T[idx], cfg.cutoff,
                                        cfg.log_composite)
            acc[idx] += torch.einsum("apk,cak->apc", w, colors)
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


def run_order(starts, cfg: V2Cfg) -> torch.Tensor:
    """The tiles, longest run first (int32 [n_tiles]): the order in which
    B1's and B2's blocks take them in training. On dense views one tile's
    run, ~80x the mean, sets a launch's time, and started last it ends
    last. One argsort a binning: _RasterCore makes it only where a backward
    follows and hands the forward's to the backward; a render with no
    backward leaves B1 in index order, where the argsort costs more than
    the order saves (0.07-0.1 ms against 0.025-0.03 on an H100 at the 1M
    scene, chip_smoke.py's b1_order)."""
    return torch.argsort(starts[1:cfg.n_tiles + 1] - starts[:cfg.n_tiles],
                         descending=True).to(torch.int32)


def raster_fwd(S, starts, masks, cfg: V2Cfg, order=None):
    """Sorted table -> per-tile outputs [n_tiles, P, CH+1] (colors, then
    alpha = 1 - T_final). ``masks`` int32 [n_tiles], 0 disables a tile;
    ``order`` the blocks' tile order (run_order's; index order if None)."""
    if S.shape != (cfg.d_s, cfg.cap) or starts.shape != (cfg.n_tiles_v + 1,) \
            or masks.shape != (cfg.n_tiles,):
        raise ValueError("raster_fwd: S, starts or masks has the wrong shape")
    if cfg.n_attr:
        raise ValueError("raster_fwd takes the 3DGS attribute layout")
    if cfg.cutoff not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff {cfg.cutoff!r}")
    if _on_cpu(S, "raster_fwd"):
        return _fwd_plain(S, starts, masks, cfg)
    dev = S.device
    if cfg.channels > MAX_CHANNELS:
        raise NotImplementedError(
            f"the tile-forward kernel takes at most {MAX_CHANNELS} "
            f"channels, got {cfg.channels}")
    if cfg.pixels > 1024:
        raise ValueError("tile_size above 32 does not fit one CUDA block")
    _check_cuda("raster_fwd S", S, torch.float32, dev)
    _check_cuda("raster_fwd starts", starts, torch.int32, dev)
    _check_cuda("raster_fwd masks", masks, torch.int32, dev)
    if order is not None:
        if order.shape != (cfg.n_tiles,):
            raise ValueError("raster_fwd: order has the wrong shape")
        _check_cuda("raster_fwd order", order, torch.int32, dev)
    out = torch.empty((cfg.n_tiles, cfg.pixels, cfg.channels + 1),
                      dtype=torch.float32, device=dev)
    err = native.lib().gsc_raster_fwd(
        S.data_ptr(), cfg.cap, starts.data_ptr(), masks.data_ptr(),
        0 if order is None else order.data_ptr(),
        cfg.n_tiles, cfg.tile_width, cfg.tile_height, cfg.tile_size,
        cfg.channels, int(cfg.cutoff == "soft"), int(cfg.log_composite),
        int(cfg.geom_packed), int(cfg.attr_packed), int(bwd_dense(cfg)),
        out.data_ptr(), _stream(),
    )
    native.check(err, "gsc_raster_fwd")
    _count_launch("raster_fwd", _input_branches(cfg))
    return out


def _input_branches(cfg: V2Cfg):
    """The tile kernels' input branches, for _count_launch."""
    return [(cfg.geom_packed or cfg.attr_packed, "_unpack"),
            (cfg.log_composite, "_log")]


# ---------------------------------------------------------------------------
# Packed pairs: two truncated-bf16 values in one 32-bit word
# ---------------------------------------------------------------------------


def pack_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> int32 words holding (trunc-bf16(a) in the high
    half | trunc-bf16(b) in the low half): the JAX package's _pack_pair.
    Truncation keeps the top 16 bits (sign, exponent, 7 mantissa bits);
    rounding (torch's .to(torch.bfloat16), CUDA's __float2bfloat16) would
    give other bits. Only integer operations touch the words."""
    ua = a.contiguous().view(torch.int32)
    ub = b.contiguous().view(torch.int32)
    # -65536 is 0xFFFF0000; >> is arithmetic on int32, so mask after it
    return (ua & -65536) | ((ub >> 16) & 0xFFFF)


def unpack_pairs(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 words -> (high half, low half) as f32 (each exact bf16)."""
    return (w & -65536).view(torch.float32), (w << 16).view(torch.float32)


# u16 fixed-point positions: 1/8 px over [-4096, 4096) px
GEOM_SCALE = 8.0
GEOM_OFF = 4096.0


def _quant_u16(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp((v + GEOM_OFF) * GEOM_SCALE + 0.5, 0.0, 65535.0).to(
        torch.int32)


def pack_u16_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two f32 position tensors -> int32 words (qx << 16) | qy, q =
    int(clip((v + 4096) * 8 + 0.5, 0, 65535)): the JAX package's
    _pack_u16_xy. A centre outside [-4096, 4096) px is clipped to the edge,
    not refused."""
    qx, qy = _quant_u16(x), _quant_u16(y)
    # qx << 16 without int32 overflow: qx's bit 15 becomes the sign bit
    return torch.where(qx >= 32768, qx - 65536, qx) * 65536 | qy


def unpack_u16_xy(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 position words -> (x, y) f32. >> is arithmetic on int32, so
    mask after it."""
    x = ((w >> 16) & 0xFFFF).to(torch.float32) / GEOM_SCALE - GEOM_OFF
    y = (w & 0xFFFF).to(torch.float32) / GEOM_SCALE - GEOM_OFF
    return x, y


def _pack_grad_rows(vals: torch.Tensor, n_attr: int,
                    absgrad: bool) -> torch.Tensor:
    """f32 gradient rows [d_g, L] -> the packed layout int32
    [ceil(n_attr / 2) (+ 1), L]: rows (0, 1), (2, 3), ..., an odd last
    row with 0, then with absgrad one (|x|, |y|) row."""
    rows = []
    for i in range(0, n_attr, 2):
        b = vals[i + 1] if i + 1 < n_attr else torch.zeros_like(vals[i])
        rows.append(pack_pairs(vals[i], b))
    if absgrad:
        rows.append(pack_pairs(vals[n_attr], vals[n_attr + 1]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# B2: tile backward (csrc/raster_bwd.cu)
# ---------------------------------------------------------------------------


def _bwd_plain(S, starts, masks, tiles, v_tiles, cfg: V2Cfg, absgrad: bool):
    """Plain version of the tile-backward kernel: the JAX package's
    front-to-back recompute (``_bwd_kernel`` without its MXU devices), over
    the chunk index and vectorised across tiles as ``_fwd_plain`` is.
    Returns the gradient rows [d_g, cap] in S's column order; columns no
    tile reaches stay zero."""
    dev = S.device
    nT, P, CH = cfg.n_tiles, cfg.pixels, cfg.channels
    off, end, c0, c1, px, py, lane, group = _tile_walk(S, starts, masks, cfg)
    gbuf = torch.zeros((cfg.d_g(absgrad), cfg.cap), dtype=torch.float32,
                       device=dev)
    zero = torch.zeros((), device=dev)
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        v_c = v_tiles[sl, :, :CH]
        v_a = v_tiles[sl, :, CH:CH + 1]
        t_final = 1.0 - tiles[sl, :, CH:CH + 1]
        q = (tiles[sl, :, :CH] * v_c).sum(-1, keepdim=True)
        nch = c1[sl] - c0[sl]
        for j in range(int(nch.max()) if n else 0):
            live = (nch > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            chunk = S[:, cols]  # [d_s, A, K]
            geo, colors = _chunk_values(cfg, chunk)
            xs, ys, ca, cb, cc, op = (v[:, None, :] for v in geo)
            dx = xs - px[sl][idx][:, :, None]  # [A, P, K]
            dy = ys - py[sl][idx][:, :, None]
            sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
                     + cb * (dx * dy))
            inr = (cols >= off[sl][idx, None]) & (cols < end[sl][idx, None])
            alpha_raw = op * torch.exp(-sigma)
            alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
            valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & inr[:, None]
            alpha = torch.where(valid, alpha, zero)
            w, m, t_prev, t_new = _composite(alpha, T[idx], cfg.cutoff,
                                             cfg.log_composite)
            oma = 1.0 - alpha
            vc = v_c[idx]
            gpk = torch.einsum("apc,cak->apk", vc, colors)
            s = q[idx] - torch.cumsum(w * gpk, dim=-1)  # suffix color term
            inv_oma = 1.0 / torch.where(oma > 0, oma, torch.ones_like(oma))
            v_alpha = (t_prev * gpk - s * inv_oma
                       + v_a[idx] * t_final[idx] * inv_oma)
            if m is not None:
                v_alpha = v_alpha * m.to(v_alpha.dtype)
            dvalid = (valid & ~(alpha_raw > MAX_ALPHA)).to(alpha.dtype)
            v_sig = -alpha * v_alpha * dvalid  # [A, P, K]
            gx = v_sig * (ca * dx + cb * dy)
            gy = v_sig * (cc * dy + cb * dx)
            rows = [gx.sum(1), gy.sum(1), (v_sig * 0.5 * dx * dx).sum(1),
                    (v_sig * dx * dy).sum(1), (v_sig * 0.5 * dy * dy).sum(1)]
            op_k = geo[5]
            rows.append(torch.where(
                op_k > 0.0,
                -v_sig.sum(1) / torch.where(op_k > 0.0, op_k,
                                            torch.ones_like(op_k)),
                zero))
            rows += list(torch.einsum("apc,apk->cak", vc, w).unbind(0))
            if absgrad:
                rows += [gx.abs().sum(1), gy.abs().sum(1)]
            vals = torch.stack(rows)  # [d_g, A, K]
            gbuf[:, cols[inr]] = vals[:, inr]
            T[idx] = t_new
            q[idx] = s[..., -1:]
    return gbuf


def _bwd_packed_plain(S, starts, masks, tiles, v_tiles, cfg: V2Cfg,
                     absgrad: bool):
    """Plain version of the tile-backward kernel's packed-pair branch."""
    return _pack_grad_rows(
        _bwd_plain(S, starts, masks, tiles, v_tiles, cfg, absgrad),
        cfg.n_attr_eff, absgrad)


# B2's candidate regions (csrc/raster_bwd.cu kCond): below this det A
# against ca * cc a conic gets no bound
BWD_COND = 1e-4
BWD_SMEM = 232448  # raster_bwd.cu kMaxSmem: a block's shared memory
# B2 takes its dense build below this many Gaussians a tile (bwd_dense)
BWD_DENSE_GAUSSIANS = 32


def bwd_dense(cfg: V2Cfg) -> bool:
    """Whether B2 and B1 take their builds for dense tiles
    (csrc/raster_bwd.cu and csrc/raster_fwd.cu kDenseThreads): fewer than
    BWD_DENSE_GAUSSIANS Gaussians (slots) a tile, as the checkpoint's views
    at 120,000 slots have (~28), whose large splats composite most pixels
    of a tile and leave a few tiles with runs ~80x the mean. The 1M scene
    has ~230, the train phase's stand-in ~39, and both ran faster at 2
    pixels a thread (PERF.md)."""
    return cfg.C * cfg.n < BWD_DENSE_GAUSSIANS * cfg.n_tiles


def bwd_pixels_per_thread(channels: int) -> int:
    """Pixels a thread of B2 and of B6 owns at ``channels`` channels
    (``ppt_for`` of the channels' template bound in csrc/raster_bwd.cu and
    csrc/raster_bwd_2dgs.cuh): 2 up to 32 channels, else 1."""
    return 2 if channels <= 32 else 1


def _warp_layout(tile_size: int, ppt: int):
    """The tile kernels' pixel layout (B1, B2, B5 and B6): ``ppt``
    neighbours of one tile row a lane, a warp the 32 lanes of a cell 8
    pixels wide and 32 / (8 / ppt) rows tall, the cells row-major. Returns
    (warps a tile, rows a cell, lane_of: int64 [P], pixel -> warp * 32 +
    lane)."""
    ts, cell_width = tile_size, 8
    ct = cell_width // ppt  # lanes a cell row
    rc = 32 // ct  # rows a cell
    cells_x = -(-ts // cell_width)
    n_warps = cells_x * -(-ts // rc)
    p = torch.arange(ts * ts)
    row, col = torch.div(p, ts, rounding_mode="floor"), p % ts
    lane_of = ((torch.div(row, rc, rounding_mode="floor") * cells_x
                + torch.div(col, cell_width, rounding_mode="floor")) * 32
               + (row % rc) * ct + torch.div(col % cell_width, ppt,
                                             rounding_mode="floor"))
    return n_warps, rc, lane_of


def bwd_build(channels: int, tile_size: int, absgrad: bool = False,
              dense: bool = False) -> dict:
    """The build of B2 that a launch at these shapes takes
    (csrc/raster_bwd.cu ``launch``; ``dense`` is bwd_dense), and at
    ``absgrad`` and ``dense`` False B8's (csrc/raster_v1_bwd.cu): the channels'
    template bound "chm", pixels a thread "ppt", the launch bounds
    "max_threads" and "min_blocks" and the pairs staged per barrier "sub"
    (the tuned builds at bounds 3 and 8: dense and up to 256 threads at 1
    pixel a thread, 256 threads for 4 blocks an SM; else 128 threads for 8,
    or the tile-32 bound for 2; at 64 and 128, 256 threads or the tile-32
    bound; at 16 and 32 the tile-32 bound; those at 1 block an SM stage as
    many pairs as shared memory holds, up to a chunk)."""
    chm = next(b for b in (3, 8, 16, 32, 64, 128) if channels <= b)
    ppt = bwd_pixels_per_thread(channels)
    n_warps, _, _ = _warp_layout(tile_size, ppt)
    if chm <= 8 and dense and _warp_layout(tile_size, 1)[0] * 32 <= 256:
        ppt, n_warps = 1, _warp_layout(tile_size, 1)[0]
        max_threads, min_blocks, sub = 256, 4, 64
    elif chm <= 8 and n_warps * 32 <= 128:
        max_threads, min_blocks, sub = 128, 8, 64
    elif chm <= 8:
        max_threads, min_blocks, sub = 1024 // ppt, 2, 64
    elif chm >= 64 and n_warps * 32 <= 256:
        max_threads, min_blocks, sub = 256, 1, K
    else:
        max_threads, min_blocks, sub = 1024 // ppt, 1, K
    dp = (6 + channels + (2 if absgrad else 0)) | 1
    fixed = (6 + channels + 3) * K * 4

    def part(s):
        return 2 * n_warps * (s * dp * 4 + -(-s // 32) * 4)

    while sub > 1 and fixed + part(sub) > BWD_SMEM:
        sub //= 2
    return dict(chm=chm, ppt=ppt, max_threads=max_threads,
                min_blocks=min_blocks, sub=sub)


FWD_SMALL_MIN_BLOCKS = 10  # raster_fwd.cu kSmallMinBlocks


def fwd_build(channels: int, tile_size: int, dense: bool = False) -> dict:
    """The build of B1 that a launch at these shapes takes
    (csrc/raster_fwd.cu ``launch``; ``dense`` is bwd_dense), and at
    ``dense`` False B7's (csrc/raster_v1_fwd.cu): the channels'
    template bound "chm", pixels a thread "ppt" (2 up to 32 channels, else
    1, and 1 in the dense build), the block's "threads" and the launch
    bounds "max_threads" and "min_blocks" (at bounds 3 and 8: dense and up
    to 256 threads at 1 pixel a thread, 256; else up to 128 threads, 128
    for FWD_SMALL_MIN_BLOCKS blocks an SM; at 64 and 128 channels, 256 up
    to 256 threads; else the tile-32 bound, 1024 / ppt)."""
    chm = next(b for b in (3, 8, 16, 32, 64, 128) if channels <= b)
    ppt = bwd_pixels_per_thread(channels)
    threads = _warp_layout(tile_size, ppt)[0] * 32
    min_blocks = 1
    if chm <= 8 and dense and _warp_layout(tile_size, 1)[0] * 32 <= 256:
        ppt, threads, max_threads = 1, _warp_layout(tile_size, 1)[0] * 32, 256
    elif chm <= 8 and threads <= 128:
        max_threads, min_blocks = 128, FWD_SMALL_MIN_BLOCKS
    elif chm >= 64 and threads <= 256:
        max_threads = 256
    else:
        max_threads = 1024 // ppt
    return dict(chm=chm, ppt=ppt, threads=threads, max_threads=max_threads,
                min_blocks=min_blocks)


def _pair_regions(geo):
    """The candidate region of each pair that B1 and B2 share
    (csrc/regions.cuh ``conic_region``, formed once a chunk from the
    unpacked values the pair math reads): ``geo`` the f32 values [x, y, ca,
    cb, cc, op], each [...] -> float32 (rx, ry, lm, rd) [...]. A pixel can
    pass the alpha test only if |x - px| <= rx, |y - py| <= ry and its
    float sigma <= lm; op < 1/255 gives -1 (no pixel), a conic that is not
    positive definite, or has det A < BWD_COND * ca * cc, +inf (no
    bound). ``rd`` is the radius of the
    expansion's conservative disc, 0.5 lam_min d^2 <= L, with the same
    margins (not used by the kernel: the counts compare it with the box).
    Formed in float64 from the float32 values, as the kernel does."""
    ca, cb, cc, op = (g.double() for g in geo[2:6])
    Lm = 1.02 * torch.clamp(torch.log(255.0 * op), min=0.0) + 0.01
    det = ca * cc - cb * cb
    ok = (ca > 0.0) & (cc > 0.0) & (det >= BWD_COND * ca * cc)
    rx = torch.sqrt(2.0 * Lm * cc / det) * 1.001 + 0.1
    ry = torch.sqrt(2.0 * Lm * ca / det) * 1.001 + 0.1
    lam_min = 0.5 * (ca + cc) - torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb)
    rd = torch.sqrt(2.0 * Lm / lam_min) * 1.001 + 0.1
    empty = ~(geo[5] >= ALPHA_THRESHOLD)
    out = []
    for v in (rx, ry, Lm, rd):
        v = torch.where(ok, v, torch.full_like(v, math.inf)).float()
        out.append(torch.where(empty, torch.full_like(v, -1.0), v))
    return tuple(out)


def _cell_bounds(cfg: V2Cfg, ppt: int):
    """The pixel centres' extent of each warp's cell in B2's layout:
    float32 (x_lo, x_hi, y_lo, y_hi), each [n_tiles, warps a tile]."""
    ts, TW = cfg.tile_size, cfg.tile_width
    n_warps, rc, _ = _warp_layout(ts, ppt)
    cells_x = -(-ts // 8)
    w = torch.arange(n_warps)
    cx, cy = w % cells_x, torch.div(w, cells_x, rounding_mode="floor")
    rem = torch.arange(cfg.n_tiles) % (TW * cfg.tile_height)
    x0 = ((rem % TW) * ts)[:, None]
    y0 = (torch.div(rem, TW, rounding_mode="floor") * ts)[:, None]
    return tuple((v + 0.5).to(torch.float32) for v in (
        x0 + cx * 8, x0 + torch.clamp(cx * 8 + 7, max=ts - 1),
        y0 + cy * rc, y0 + torch.clamp(cy * rc + rc - 1, max=ts - 1)))


def _bwd_counts(S, starts, masks, cfg: V2Cfg):
    """What B2 does on these inputs: _region_counts in B2's layout
    (_warp_layout at bwd_build's pixels a lane)."""
    ppt = bwd_build(cfg.channels, cfg.tile_size, dense=bwd_dense(cfg))["ppt"]
    return _region_counts(S, starts, masks, cfg, ppt)


def _fwd_counts(S, starts, masks, cfg: V2Cfg):
    """What B1 does on these inputs: _region_counts in B1's layout
    (_warp_layout at fwd_build's pixels a lane). B1 also stops a pixel's
    candidates at its exact cutoff within a chunk, which the counts do
    not."""
    ppt = fwd_build(cfg.channels, cfg.tile_size, dense=bwd_dense(cfg))["ppt"]
    return _region_counts(S, starts, masks, cfg, ppt)


def _region_counts(S, starts, masks, cfg: V2Cfg, ppt: int):
    """What the 3DGS tile kernels do on these inputs, from the plain walk
    (a tile stops when every pixel has T <= 1e-4 at a chunk's start: the
    backward's rule, and the forward's, whose exact cutoff leaves every
    pixel's T above 1e-4), in the layout of ``ppt`` pixels a lane
    (_warp_layout). Returns a dict of
      "run": int64 [n_tiles], rows of the tile's run that the walk reaches;
      "pairs": int64 [n_tiles], pairs that at least one pixel composited;
      "slots": int64 [n_tiles], composited (pair, pixel) slots;
      "evaluated_slots": the (pair, pixel) slots walked;
      "candidate_slots": those in a warp whose cell meets the pair's box
        and whose float sigma is within the pair's bound lm (_pair_regions):
        the ones that can pass (B2 forms the alpha of every pixel of a
        (pair, warp) that holds one, B1 that of every candidate pixel of a
        thread that holds one);
      "missed_slots": slots that pass the alpha test outside them (0: the
        regions hold every pixel that passes);
      "pair_warp_walked": the (pair, warp) walked;
      "pair_warp_cells": {"box", "disc", "box_and_disc"}: the (pair, warp)
        whose cell meets the pair's box (B1's and B2's test), its disc of
        radius rd, or both: the ones that evaluate the pair's sigma;
      "pair_warp_candidates": (pair, warp) with at least one candidate slot;
      "pair_warp_hits": (pair, warp) with at least one composited pixel,
        each a warp reduction (or the ballot shortcut) in the kernel;
      "single_lane_hits": those where exactly one lane composited the
        pair (the ballot shortcut's);
      "warps_per_tile": the warps that cover a tile's pixels."""
    dev = S.device
    nT, P = cfg.n_tiles, cfg.pixels
    off, end, c0, c1, px, py, lane, group = _tile_walk(S, starts, masks, cfg)
    n_warps, _, lane_of = _warp_layout(cfg.tile_size, ppt)
    lane_of = lane_of.to(dev)
    warp_of = torch.div(lane_of, 32, rounding_mode="floor")
    cells = [v.to(dev) for v in _cell_bounds(cfg, ppt)]
    i64 = dict(dtype=torch.int64, device=dev)
    counts = {k: torch.zeros(nT, **i64) for k in ("run", "pairs", "slots")}
    totals = {k: torch.zeros((), **i64) for k in (
        "evaluated_slots", "candidate_slots", "missed_slots",
        "pair_warp_walked", "pair_warp_candidates", "pair_warp_hits",
        "single_lane_hits", "box", "disc", "box_and_disc")}

    def by_warp(mask):
        """[A, P, K] -> lanes hit [A, n_warps, K]."""
        A = mask.shape[0]
        lanes = torch.zeros((A, n_warps * 32, K), dtype=torch.int32,
                            device=dev).index_add_(1, lane_of,
                                                   mask.to(torch.int32))
        return (lanes > 0).view(A, n_warps, 32, K).sum(2)

    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        nch = c1[sl] - c0[sl]
        for j in range(int(nch.max()) if n else 0):
            live = (nch > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            t = idx + g0
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            inr = (cols >= off[sl][idx, None]) & (cols < end[sl][idx, None])
            geo, _ = _chunk_values(cfg, S[:, cols])
            xs, ys, ca, cb, cc, op = (v[:, None, :] for v in geo)
            dx = xs - px[t][:, :, None]  # [A, P, K]
            dy = ys - py[t][:, :, None]
            sigma = ((0.5 * ca) * (dx * dx) + (0.5 * cc) * (dy * dy)
                     + cb * (dx * dy))
            alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
            valid = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) \
                & inr[:, None]
            alpha = torch.where(valid, alpha, torch.zeros((), device=dev))
            _, m, _, t_new = _composite(alpha, T[idx], cfg.cutoff,
                                        cfg.log_composite)
            comp = valid if m is None else valid & m  # [A, P, K]
            rx, ry, lm, rd = (v[:, None, :] for v in _pair_regions(geo))
            xlo, xhi, ylo, yhi = (v[t][:, :, None] for v in cells)
            ex = xs - torch.minimum(torch.maximum(xs, xlo), xhi)
            ey = ys - torch.minimum(torch.maximum(ys, ylo), yhi)
            w_in = inr[:, None, :]  # [A, 1, K]
            box = (ex.abs() <= rx) & (ey.abs() <= ry) & w_in
            disc = (ex * ex + ey * ey <= rd * rd) & w_in
            walked = inr[:, None, :].expand_as(comp)
            cand = box[:, warp_of] & (sigma <= lm) & walked
            counts["run"][t] += inr.sum(-1)
            counts["pairs"][t] += comp.any(1).sum(-1)
            counts["slots"][t] += comp.sum((1, 2))
            totals["evaluated_slots"] += walked.sum()
            totals["candidate_slots"] += cand.sum()
            totals["missed_slots"] += (valid & ~cand).sum()
            totals["pair_warp_walked"] += n_warps * inr.sum()
            totals["box"] += box.sum()
            totals["disc"] += disc.sum()
            totals["box_and_disc"] += (box & disc).sum()
            totals["pair_warp_candidates"] += (by_warp(cand) > 0).sum()
            lanes_hit = by_warp(comp)
            totals["pair_warp_hits"] += (lanes_hit > 0).sum()
            totals["single_lane_hits"] += (lanes_hit == 1).sum()
            T[idx] = t_new
    cells_out = {k: int(totals.pop(k)) for k in ("box", "disc",
                                                 "box_and_disc")}
    return dict(**counts, **{k: int(v) for k, v in totals.items()},
                pair_warp_cells=cells_out, warps_per_tile=n_warps)


def raster_bwd(S, starts, masks, tiles, v_tiles, cfg: V2Cfg,
               absgrad: bool = False, packed: bool = False, order=None):
    """Tile backward: the sorted table, the forward's tile outputs and their
    cotangents [n_tiles, P, CH+1] -> per-intersection gradient rows
    [d_g, cap] (x, y, ca, cb, cc, op, colors[CH], and |x|, |y| with
    ``absgrad``), column j holding the gradient of S's column j. Columns no
    tile reaches (early stop, masked tiles, the overflow tile, rows past
    n_isects) are zero. With ``packed`` the rows come as packed pairs,
    int32 [d_gp, cap] (_pack_grad_rows' layout): the same f32 sums,
    truncated at the final write. ``order`` is the blocks' tile order
    (run_order's, made here if None)."""
    tshape = (cfg.n_tiles, cfg.pixels, cfg.channels + 1)
    if S.shape != (cfg.d_s, cfg.cap) or starts.shape != (cfg.n_tiles_v + 1,) \
            or masks.shape != (cfg.n_tiles,) or tiles.shape != tshape \
            or v_tiles.shape != tshape:
        raise ValueError("raster_bwd: an input has the wrong shape")
    if cfg.n_attr:
        raise ValueError("raster_bwd takes the 3DGS attribute layout")
    if cfg.cutoff not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff {cfg.cutoff!r}")
    if _on_cpu(S, "raster_bwd"):
        if packed:
            return _bwd_packed_plain(S, starts, masks, tiles, v_tiles, cfg,
                                     absgrad)
        return _bwd_plain(S, starts, masks, tiles, v_tiles, cfg, absgrad)
    dev = S.device
    if cfg.channels > MAX_CHANNELS:
        raise NotImplementedError(
            f"the tile-backward kernel takes at most {MAX_CHANNELS} "
            f"channels, got {cfg.channels}")
    if cfg.pixels > 1024:
        raise ValueError("tile_size above 32 does not fit one CUDA block")
    _check_cuda("raster_bwd S", S, torch.float32, dev)
    _check_cuda("raster_bwd starts", starts, torch.int32, dev)
    _check_cuda("raster_bwd masks", masks, torch.int32, dev)
    _check_cuda("raster_bwd tiles", tiles, torch.float32, dev)
    _check_cuda("raster_bwd v_tiles", v_tiles, torch.float32, dev)
    if packed:
        gbuf = torch.zeros((cfg.d_gp(absgrad), cfg.cap), dtype=torch.int32,
                           device=dev)
    else:
        gbuf = torch.zeros((cfg.d_g(absgrad), cfg.cap), dtype=torch.float32,
                           device=dev)
    if order is None:
        order = run_order(starts, cfg)
    if order.shape != (cfg.n_tiles,):
        raise ValueError("raster_bwd: order has the wrong shape")
    _check_cuda("raster_bwd order", order, torch.int32, dev)
    err = native.lib().gsc_raster_bwd(
        S.data_ptr(), cfg.cap, starts.data_ptr(), masks.data_ptr(),
        order.data_ptr(), tiles.data_ptr(), v_tiles.data_ptr(), cfg.n_tiles,
        cfg.tile_width, cfg.tile_height, cfg.tile_size, cfg.channels,
        int(cfg.cutoff == "soft"), int(absgrad), int(packed),
        int(cfg.log_composite), int(cfg.geom_packed), int(cfg.attr_packed),
        int(bwd_dense(cfg)), gbuf.data_ptr(), _stream(),
    )
    native.check(err, "gsc_raster_bwd")
    _count_launch("raster_bwd", [(packed, "_packed")] + _input_branches(cfg))
    return gbuf


# ---------------------------------------------------------------------------
# B9b: unpack rows (csrc/unpack.cu)
# ---------------------------------------------------------------------------


def _unpack_rows_plain(block: torch.Tensor, n: int,
                       idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    if idx is None:
        return block[:n].contiguous()
    words = block.view(torch.int32)  # move bits, never float values
    out = torch.empty((n, idx.shape[0]), dtype=torch.int32,
                      device=block.device)
    out[:, idx] = words[:n, :idx.shape[0]]
    return out.view(block.dtype)


# B9b's row groups (csrc/unpack.cu): the source rows that one pass of the
# gather reads through the inverse permutation, kept within L2
UNPACK_L2_BYTES = 32 << 20


def unpack_row_group(L_src: int, n: int) -> int:
    """Rows that B9b gathers in one pass over the columns: as many of the
    [n, L_src] block's 4-byte rows as fit in UNPACK_L2_BYTES, at least one,
    all n where they fit."""
    return max(1, min(n, UNPACK_L2_BYTES // (4 * max(L_src, 1))))


def unpack_rows(block: torch.Tensor, n: int,
                idx: Optional[torch.Tensor] = None,
                group: Optional[int] = None) -> torch.Tensor:
    """The first n rows of an f32 or int32 [R, L_src] block as one [n, L]
    tensor of its dtype; with ``idx`` (an int64 permutation of [0, L),
    L <= L_src) column j goes to column idx[j]: the scatter that undoes
    pack_rows' gather by idx. Only 4-byte words move: packed pairs keep
    their bits. On the card the gather takes ``group`` rows at a time
    (unpack_row_group's by default)."""
    if block.ndim != 2 or block.dtype not in (torch.float32, torch.int32) \
            or not 0 < n <= block.shape[0]:
        raise ValueError(f"unpack_rows: {n} rows of a float32 or int32 "
                         f"[R, L] block")
    if idx is not None and (idx.ndim != 1 or idx.dtype != torch.int64
                            or idx.shape[0] > block.shape[1]):
        raise ValueError("unpack_rows: idx must be int64 [L], L <= L_src")
    if _on_cpu(block, "unpack_rows"):
        return _unpack_rows_plain(block, n, idx)
    dev = block.device
    _check_cuda("unpack_rows block", block, block.dtype, dev)
    if idx is not None:
        _check_cuda("unpack_rows idx", idx, torch.int64, dev)
    L = block.shape[1] if idx is None else idx.shape[0]
    out = torch.empty((n, L), dtype=block.dtype, device=dev)
    inv = None if idx is None else torch.empty(L, dtype=torch.int32,
                                               device=dev)
    err = native.lib().gsc_unpack_rows(
        block.data_ptr(), block.shape[1], n,
        unpack_row_group(block.shape[1], n) if group is None else group,
        None if idx is None else idx.data_ptr(), L,
        None if inv is None else inv.data_ptr(), out.data_ptr(), _stream(),
    )
    native.check(err, "gsc_unpack_rows")
    LAUNCHES["unpack_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# B4: segment sums (csrc/segsum.cu)
# ---------------------------------------------------------------------------


def segment_ids(cum: torch.Tensor, n_isects: torch.Tensor) -> torch.Tensor:
    """The compacted id of each of the first n_isects expansion rows (int64
    [n_isects]): row j belongs to the id r with cum[r-1] <= j < cum[r]."""
    n = int(n_isects.reshape(-1)[0])
    j = torch.arange(n, dtype=torch.int32, device=cum.device)
    return torch.searchsorted(cum, j, right=True)


# B4's partition (csrc/segsum.cu kItems, kPer): each warp takes this many
# items of the merged sequence of columns and range ends, a lane 8 of its
# columns (from the 16-byte boundary at or below the warp's first)
SEG_WARP_ITEMS = 252
SEG_LANE_COLUMNS = 8


def _range_ends(cum: torch.Tensor, n_isects: torch.Tensor) -> torch.Tensor:
    """End of each id's column range, min(cum[r], n_isects) (int64 [M])."""
    return torch.clamp(cum.long(), max=int(n_isects.reshape(-1)[0]))


def segsum_partition(cum: torch.Tensor, n_isects: torch.Tensor,
                     items: int = SEG_WARP_ITEMS):
    """B4's merge-path partition (Merrill and Garland, SC16) of the merged
    sequence in which id r's columns [e[r-1], e[r]) come before its end
    item, e = min(cum, n_isects): the end item of id r sits at r + e[r].
    Warp w takes the items [w * items, (w + 1) * items): the end items of
    ids [i[w], i[w+1]) and the columns [j[w], j[w+1]). Returns (i, j),
    int64 [warps + 1]."""
    e = _range_ends(cum, n_isects).cpu()
    M = e.shape[0]
    K = M + (int(e[-1]) if M else 0)
    k = torch.clamp(torch.arange(-(-K // items) + 1) * items, max=K)
    i = torch.searchsorted(torch.arange(M) + e, k)  # end items before k
    return i, k - i


def segsum_counts(cum: torch.Tensor, n_isects: torch.Tensor, d: int,
                  items: int = SEG_WARP_ITEMS) -> dict:
    """B4's work on these ranges, for ``d`` gradient rows: the range
    lengths (max, p99 and mean over the live ids, the ids longer than one
    warp's items); the first design's longest walk (4 lanes an id, 8 ids
    a warp: a warp waits for its longest range's ceil(len / 4) loads of
    each row); and the merge-path partition's warps, the largest warp's
    columns and loads (columns x d) and a lane's loads (SEG_LANE_COLUMNS
    words a row)."""
    e = _range_ends(cum, n_isects).cpu()
    lens = torch.diff(e, prepend=e.new_zeros(1))
    live = torch.sort(lens[lens > 0]).values
    walk = -(-lens // 4)
    walk = torch.cat([walk, walk.new_zeros(-walk.shape[0] % 8)])
    _, j = segsum_partition(cum, n_isects, items)
    cols = torch.diff(j)
    n_live = live.shape[0]
    top = int(cols.max()) if cols.numel() else 0
    return dict(
        ids=int(lens.shape[0]), live_ids=n_live,
        intersections=int(e[-1]) if lens.shape[0] else 0, rows=d,
        max_range=int(live[-1]) if n_live else 0,
        p99_range=int(live[-(-99 * n_live // 100) - 1]) if n_live else 0,
        mean_range=float(live.double().mean()) if n_live else 0.0,
        ids_over_warp=int((lens > items).sum()),
        parent_warp_loads=int(walk.reshape(-1, 8).amax(1).max()) * d
        if walk.numel() else 0,
        warp_items=items, warps=int(cols.shape[0]), max_warp_columns=top,
        max_warp_loads=top * d,
        max_lane_loads=SEG_LANE_COLUMNS * d if top else 0)


def _segsum_plain(rows, cum, n_isects):
    if rows.dtype == torch.int32:  # packed pairs: high halves, low halves
        hi, lo = unpack_pairs(rows)
        rows = torch.cat([hi, lo])
    out = torch.zeros((rows.shape[0], cum.shape[0]), dtype=torch.float32,
                      device=rows.device)
    ids = segment_ids(cum, n_isects)
    return out.index_add_(1, ids, rows[:, :ids.shape[0]])


def segsum_rows_bound(rows: torch.Tensor, cum: torch.Tensor,
                      n_isects: torch.Tensor) -> torch.Tensor:
    """Largest |segsum_rows - _segsum_plain| that summation order alone can
    give, per output entry (float64, the shape of the sums). Both add a
    segment's n f32 terms in their own order: the kernel as a tree of
    pairwise sums (a lane's running sum over its 8 columns, a segmented
    scan over the lanes, then the warps' partial sums in warp order),
    index_add_ in some sequence. Any such order of n terms (adding an
    exact zero rounds nothing) puts at most n - 1 roundings on a term, so
    each is within gamma(n + 1) * sum|x| of the exact sum,
    gamma(k) = k u / (1 - k u) (Higham, Accuracy and Stability of
    Numerical Algorithms, ch. 4), and the two within twice that. Zero for
    an empty segment."""
    if rows.dtype == torch.int32:
        rows = torch.cat(unpack_pairs(rows))
    ids = segment_ids(cum, n_isects)
    asum = torch.zeros((rows.shape[0], cum.shape[0]), dtype=torch.float64,
                       device=rows.device).index_add_(
        1, ids, rows[:, :ids.shape[0]].abs().double())
    ku = (torch.bincount(ids, minlength=cum.shape[0]).double() + 1) \
        * 2.0 ** -24
    return 2 * ku / (1 - ku) * asum


def segsum_rows(rows: torch.Tensor, cum: torch.Tensor,
                n_isects: torch.Tensor) -> torch.Tensor:
    """Per-id sums of rows in expansion order: f32 [d, L] -> [d, M], column
    r summing the columns [min(cum[r-1], n_isects), min(cum[r], n_isects))
    (cum[-1] read as 0). ``cum`` is the int32 inclusive count prefix [M];
    a truncated list (total > cap) leaves the cut ids with partial sums and
    every later id empty. On the card, warps of SEG_WARP_ITEMS items of
    the merge-path partition (segsum_partition) and a last pass over the
    partial sums of the ids that cross warps: fixed order, no atomics.
    Packed pairs (int32 [d, L]) give f32 [2d, M]: the sums of the high
    halves, then those of the low halves."""
    if rows.ndim != 2 or rows.dtype not in (torch.float32, torch.int32) \
            or cum.ndim != 1:
        raise ValueError("segsum_rows: rows float32 or int32 [d, L], cum [M]")
    if _on_cpu(rows, "segsum_rows"):
        return _segsum_plain(rows, cum, n_isects)
    dev = rows.device
    packed = rows.dtype == torch.int32
    _check_cuda("segsum_rows rows", rows, rows.dtype, dev)
    _check_cuda("segsum_rows cum", cum, torch.int32, dev)
    _check_cuda("segsum_rows n_isects", n_isects, torch.int32, dev)
    d, M = rows.shape[0], cum.shape[0]
    d_out = (2 if packed else 1) * d
    out = torch.empty((d_out, M), dtype=torch.float32, device=dev)
    # the merge-path warps for n_isects = L: each one's partial sums of
    # the id still open at its end, that id, and each one's first id (one
    # allocation: f32 [d_out, nw], then int32 [2 nw + 1])
    nw = -(-(M + rows.shape[1]) // SEG_WARP_ITEMS)
    scratch = torch.empty(d_out * nw + 2 * nw + 1, dtype=torch.int32,
                          device=dev)
    err = native.lib().gsc_segsum_rows(
        rows.data_ptr(), rows.shape[1], d, cum.data_ptr(), M,
        n_isects.data_ptr(), int(packed), nw, scratch.data_ptr(),
        scratch[d_out * nw:].data_ptr(), out.data_ptr(), _stream(),
    )
    native.check(err, "gsc_segsum_rows")
    LAUNCHES["segsum_rows_packed" if packed else "segsum_rows"] += 1
    return out


def _reduce_grads(gbuf, perm, cum, order, n_isects) -> torch.Tensor:
    """Per-intersection gradient rows [d_g, cap] in S's column order ->
    per-Gaussian sums [d_g, M] in the original order. The expansion
    enumerates intersections id-major, so once S's column j is scattered
    back to expansion position perm[j] the rows of compacted id r lie in
    [cum[r-1], cum[r]) and the segment sums need no id sort; scattering
    the sums through the depth order restores the input order."""
    d_g = gbuf.shape[0]
    rows = unpack_rows(gbuf, d_g, perm)
    seg = segsum_rows(rows, cum, n_isects)
    return unpack_rows(seg, d_g, order)


def _reduce_grads_packed(gpk, perm, cum, order, n_isects, n_attr: int,
                         absgrad: bool) -> torch.Tensor:
    """_reduce_grads for packed pairs (int32 [d_gp, cap]) -> the
    per-Gaussian sums [d_g, M] in the original order, each truncated to
    bf16 as the JAX package's reduction leaves them: the segment sums
    come as f32 high and low halves, and are packed again as pairs, in
    value order, for the scatter through the depth order."""
    rows = unpack_rows(gpk, gpk.shape[0], perm)
    pairs = repack_sums(segsum_rows(rows, cum, n_isects), n_attr, absgrad)
    hi, lo = unpack_pairs(unpack_rows(pairs, pairs.shape[0], order))
    n = n_attr + (2 if absgrad else 0)
    return torch.stack([hi, lo], 1).reshape(2 * pairs.shape[0], -1)[:n]


def repack_sums(seg: torch.Tensor, n_attr: int,
                absgrad: bool) -> torch.Tensor:
    """Packed segment sums f32 [2d, M] (the high halves' sums, then the low
    halves') -> the per-Gaussian values packed again as pairs in value
    order, int32 [ceil(n / 2), M]: (0, 1), (2, 3), ..., with absgrad
    (..., |x|, |y|) continuing the sequence."""
    d = seg.shape[0] // 2
    vals = [seg[(i % 2) * d + i // 2] for i in range(n_attr)]
    if absgrad:
        vals += [seg[d - 1], seg[2 * d - 1]]
    n = len(vals)
    return torch.stack([
        pack_pairs(vals[i], vals[i + 1] if i + 1 < n
                   else torch.zeros_like(vals[i]))
        for i in range(0, n, 2)])


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class _RasterCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, absgrad, packed, ordered, means2d, conics,
                colors, opacities, depths, radii, masks, ag_probe):
        del ag_probe  # its gradient carries absgrad out of the backward
        b = _build_sorted(cfg, means2d, conics, colors, opacities, depths,
                          radii)
        # B1's and B2's tile order, where a backward follows
        runs = run_order(b.starts, cfg) if ordered else None
        tiles = raster_fwd(b.S, b.starts, masks, cfg, order=runs)
        ctx.mark_non_differentiable(b.n_isects)
        ctx.cfg, ctx.absgrad, ctx.packed = cfg, absgrad, packed
        ctx.save_for_backward(b.S, b.starts, masks, tiles, b.cum, b.order,
                              b.perm, b.n_isects, runs)
        return tiles, b.n_isects

    @staticmethod
    def backward(ctx, v_tiles, _):
        S, starts, masks, tiles, cum, order, perm, n_isects, runs = \
            ctx.saved_tensors
        cfg = ctx.cfg
        gbuf = raster_bwd(S, starts, masks, tiles,
                          v_tiles.to(torch.float32).contiguous(), cfg,
                          ctx.absgrad, ctx.packed, order=runs)
        if ctx.packed:
            g = _reduce_grads_packed(gbuf, perm, cum, order, n_isects,
                                     cfg.n_attr_eff, ctx.absgrad).T
        else:
            g = _reduce_grads(gbuf, perm, cum, order, n_isects).T
        C, N, CH = cfg.C, cfg.n, cfg.channels
        v_ag = g[:, 6 + CH:8 + CH].reshape(C, N, 2) if ctx.absgrad else None
        return (None, None, None, None, g[:, 0:2].reshape(C, N, 2),
                g[:, 2:5].reshape(C, N, 3), g[:, 6:6 + CH].reshape(C, N, CH),
                g[:, 5].reshape(C, N), None, None, None, v_ag)


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
    """Differentiable fused binning + tile rasterization.

    Returns ([C,H,W,CH] colors, [C,H,W,1] alphas, meta) with
    meta["n_isects"] = min(total intersections, capacity) as an int32 [1]
    tensor. The capacity is ``isect_capacity`` rounded up to a multiple of
    4096, as in the JAX package. Gradients reach means2d, conics, colors,
    opacities and backgrounds; with ``absgrad_probe`` ([C, N, 2] zeros) the
    probe's gradient is the per-Gaussian sum of |per-pixel dL/d(x, y)|.
    ``grad_dtype="bf16"`` carries the per-intersection gradients as packed
    pairs of truncated bf16 values; the gradients are then truncated bf16
    sums of truncated bf16 terms. ``attr_dtype="bf16"``, ``geom_dtype="u16"``
    and ``log_composite`` are the sorted table's precision knobs (module
    docstring); the gradients are those of the values the kernels read."""
    if grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown grad_dtype {grad_dtype!r}")
    if attr_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown attr_dtype {attr_dtype!r}")
    if geom_dtype not in ("f32", "u16"):
        raise ValueError(f"unknown geom_dtype {geom_dtype!r}")
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
                channels=CH, cap=cap, n=N, cutoff=cutoff_mode,
                attr_dtype=attr_dtype, geom_dtype=geom_dtype,
                log_composite=bool(log_composite))
    if masks is None:
        masks_arr = torch.ones(cfg.n_tiles, dtype=torch.int32, device=dev)
    else:
        masks_arr = torch.as_tensor(masks, device=dev).reshape(
            cfg.n_tiles).to(torch.int32)
    ordered = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (means2d, conics, colors, opacities, absgrad_probe))
    tiles, n_isects = _RasterCore.apply(
        cfg, absgrad_probe is not None, grad_dtype == "bf16", ordered,
        means2d, conics, colors, opacities,
        depths, radii, masks_arr, absgrad_probe,
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


# ---------------------------------------------------------------------------
# B10: row cumsum (csrc/cumsum_rows.cu)
# ---------------------------------------------------------------------------

CUMSUM_THREADS = 128  # cumsum_rows.cu THREADS: threads of a block
CUMSUM_CHUNKS = 8  # cumsum_rows.cu CHUNKS: 16-byte vectors a thread
CUMSUM_SEG = CUMSUM_THREADS * 4 * CUMSUM_CHUNKS  # elements of a row a block
CUMSUM_GROUP = 128  # cumsum_rows.cu GROUP: segments one scan prefixes


def _cumsum_layout(L: int) -> Tuple[int, int]:
    """(segments, groups) of a row of length L in B10's layout."""
    n_seg = -(-L // CUMSUM_SEG)
    return n_seg, -(-n_seg // CUMSUM_GROUP)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of f32 [R, L] (the JAX package's
    cumsum_rows; here the v1 "sort" reduction's running sums,
    rasterize_pallas.segment_reduce). The plain version is
    torch.cumsum(x, 1). The kernel reads x once and adds in a fixed order
    of its own (csrc/cumsum_rows.cu): 4096-element segments, their totals
    scanned in groups of 128, the groups' prefixes chained."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("cumsum_rows: x float32 [R, L]")
    if _on_cpu(x, "cumsum_rows"):
        return torch.cumsum(x, 1)
    dev = x.device
    _check_cuda("cumsum_rows x", x, torch.float32, dev)
    R, L = x.shape
    n_seg, n_grp = _cumsum_layout(L)
    if R * n_seg >= 1 << 31:
        raise ValueError(f"cumsum_rows: [{R}, {L}] is over 2^31 segments")
    # the segments' totals, the groups' prefixes and the ticket counter
    status = torch.zeros(R * (n_seg + n_grp) + 1, dtype=torch.int64,
                         device=dev)
    out = torch.empty_like(x)
    err = native.lib().gsc_cumsum_rows(x.data_ptr(), R, L, status.data_ptr(),
                                       out.data_ptr(), _stream())
    native.check(err, "gsc_cumsum_rows")
    LAUNCHES["cumsum_rows"] += 1
    return out


def cumsum_rows_bound(x: torch.Tensor) -> torch.Tensor:
    """Elementwise float64 bound on |cumsum_rows(x) - the exact cumsum| for
    the kernel's order of additions: gamma_D times the sum of |x| up to the
    element (the kernel's sum for an element takes no term after it),
    gamma_D = D u / (1 - D u), u = 2^-24. D = 26 + the groups a row is the
    most roundings a term meets (csrc/cumsum_rows.cu): 3 in its thread, 5
    in its chunk's warp scan and 5 in its segment's pieces to the
    segment's total; 3 in its lane and 5 across the lanes to its group's
    total, or the same and one add to a later segment's prefix in its
    group; one a group on the chain of the groups' prefixes; and 4 that
    join the prefixes to the value."""
    du = (26 + _cumsum_layout(x.shape[1])[1]) * 2.0 ** -24
    return du / (1 - du) * torch.cumsum(x.abs().double(), 1)
