"""Fused 2DGS (surfel) tile rasterization, forward and backward (port of
gscodec_studio_tpu/ops/raster_v2_2dgs.py), on raster_v2's skeleton: the
same compaction sort, pack (B9a), expansion (B3, in its no-cull branch:
surfels are binned by their AABB), tile sort and starts, and the same
gradient reduction (B9b, B4, B9b). What differs from 3DGS:

  * the pair weight: the ray-surfel intersection through the
    homogeneous-plane cross product, ``h_u = px*M_2 - M_0``,
    ``h_v = py*M_2 - M_1``, ``s = cross(h_u, h_v)`` flattened by its z;
    sigma = 0.5 * min(UV Gaussian, 2x-filtered screen Gaussian);
  * the attribute rows carry the 3x3 ray transform instead of a conic;
  * the per-pixel outputs add the accumulated normals (as colour
    channels), the distortion accumulator and the median depth (the depth
    of the last composited pair with T_prev > 0.5; not differentiated);
  * the backward adds the distortion chain, per pair
    ``Dw = 2 v_d (z P - A + SZ - z S)`` with ``P = 1 - T_prev``,
    ``A`` the prefix sum of w z, ``S = T_incl - T_final`` and
    ``SZ = WZ_total - A - w z``.

``absgrad`` (cfg_2dgs, from ``rasterize_to_pixels_2dgs_v2``'s
``absgrad_probe``) adds two gradient rows, the per-intersection sums of
|2 dx v_sig| and |2 dy v_sig| where the screen filter set sigma (the
means2d terms of that branch); the probe's gradient is their per-surfel
sum.

``log_composite`` takes raster_v2's log-space scan (``_composite_log``)
in both kernels: the weights, the distortion, the median's T_prev > 0.5
test and the cutoffs follow its T_prev; the backward's suffix term takes
T_incl in product form, T_prev * (1 - alpha), as the JAX kernel does.

Sorted attribute rows (n_attr = 12 + CB, CB = user channels + 3 normals,
the depth the last user channel): x, y, m00..m22, op, colors[CB]; the
gradient rows mirror them.

Kernel wrappers: ``raster_fwd_2dgs`` (B5, csrc/raster_fwd_2dgs.cu) and
``raster_bwd_2dgs`` (B6, csrc/raster_bwd_2dgs.cu) launch their CUDA kernel
for CUDA tensors and count it in ``raster_v2.LAUNCHES``; for CPU tensors
they run the plain versions beside them (``_fwd_2dgs_plain``,
``_bwd_2dgs_plain``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gscodec_studio_tpu_torch import native
from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.ops import raster_v2 as rv
from gscodec_studio_tpu_torch.ops.raster_v2 import (
    ALPHA_THRESHOLD, CAP_BLOCK, K, MAX_ALPHA, MAX_CHANNELS,
    TRANSMITTANCE_EPS, V2Cfg, bwd_pixels_per_thread)

FILTER_INV_SQUARE = 2.0
# B5 and B6 give a pair no candidate region when |det M| is below this
# times the product of M's column norms taken about the ellipse's centre:
# the camera lies nearly in the surfel's plane (csrc/regions.cuh kFlat)
FLAT_RATIO = 1e-3

# attribute-row offsets
_AX = 0
_AY = 1
_AM = 2  # 9 rows m00..m22 (M[r, c] at _AM + 3*r + c)
_AOP = 11
_ACOL = 12  # CB rows: user colors (the depth last), normals[3]


def cfg_2dgs(C: int, tile_width: int, tile_height: int, tile_size: int,
             CB: int, cap: int, N: int, cutoff: str = "exact",
             log_composite: bool = False, absgrad: bool = False) -> V2Cfg:
    """The skeleton's configuration for CB composited channels; with
    ``absgrad`` the backward writes the two |means2d| rows."""
    return V2Cfg(C=C, tile_width=tile_width, tile_height=tile_height,
                 tile_size=tile_size, channels=CB, cap=cap, n=N,
                 cutoff=cutoff, n_attr=12 + CB, cull=False, extra_out=2,
                 log_composite=log_composite, absgrad=absgrad)


def _attr_rows_2dgs(cfg: V2Cfg, means2d, transforms, colors, opacities):
    """The 12 + CB per-Gaussian rows as strided views of the contiguous
    inputs."""
    M = cfg.C * cfg.n
    m2 = means2d.reshape(M, 2)
    tr = transforms.reshape(M, 9)
    cf = colors.reshape(M, cfg.channels)
    return ([m2[:, 0], m2[:, 1]] + [tr[:, i] for i in range(9)]
            + [opacities.reshape(M)] + [cf[:, i] for i in range(cfg.channels)])


# ---------------------------------------------------------------------------
# Per-pair math and compositing, shared by the plain versions
# ---------------------------------------------------------------------------


def _chunk_pair_2dgs(chunk, px, py, inr):
    """The 2DGS pair math of one chunk. ``chunk`` [d_s, A, K] rows, ``px``,
    ``py`` [A, P, 1] pixel centres, ``inr`` [A, 1, K] rows in the tile's
    run. Every map is [A, P, K]; the expressions are the kernels', term for
    term, so they round alike (the kernels are built with --fmad=false)."""
    xs, ys = chunk[_AX][:, None, :], chunk[_AY][:, None, :]
    m = [chunk[_AM + i][:, None, :] for i in range(9)]
    op = chunk[_AOP][:, None, :]
    hu_x = px * m[6] - m[0]
    hu_y = px * m[7] - m[1]
    hu_z = px * m[8] - m[2]
    hv_x = py * m[6] - m[3]
    hv_y = py * m[7] - m[4]
    hv_z = py * m[8] - m[5]
    cx = hu_y * hv_z - hu_z * hv_y
    cy = hu_z * hv_x - hu_x * hv_z
    cz = hu_x * hv_y - hu_y * hv_x
    nz = cz != 0.0
    inv_cz = 1.0 / torch.where(nz, cz, torch.ones_like(cz))
    su = cx * inv_cz
    sv = cy * inv_cz
    gw3d = su * su + sv * sv
    dx = xs - px
    dy = ys - py
    gw2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    sigma = 0.5 * torch.minimum(gw3d, gw2d)
    alpha_raw = op * torch.exp(-sigma)
    alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
    valid = nz & (alpha >= ALPHA_THRESHOLD) & inr
    alpha = torch.where(valid, alpha, torch.zeros((), device=chunk.device))
    return dict(alpha=alpha, valid=valid, clamped=alpha_raw > MAX_ALPHA,
                su=su, sv=sv, inv_cz=inv_cz, nz=nz, dx=dx, dy=dy,
                hu=(hu_x, hu_y, hu_z), hv=(hv_x, hv_y, hv_z),
                b3=gw3d <= gw2d, op=op)


def _composite_seq(alpha, t_cur, cutoff, log: bool = False):
    """Front-to-back weights of one chunk, pair after pair as the kernels
    walk them, so T_prev has the kernels' bits (the median's T_prev > 0.5
    test and the exact cutoff then decide alike). alpha [A, P, K] (0 for
    pairs that fail the tests), t_cur [A, P, 1] -> (w, m, t_prev, t_new);
    m is None for the soft cutoff. "exact": a pixel takes the pairs before
    the first one whose T_prev * (1 - alpha) falls to <= 1e-4. ``log``
    selects raster_v2's log-space scan, which walks its sums in order
    too."""
    if log:
        return rv._composite_log(alpha, t_cur, cutoff)
    t_prev = torch.empty_like(alpha)
    take = torch.empty(alpha.shape, dtype=torch.bool, device=alpha.device)
    T = t_cur[..., 0]
    live = torch.ones_like(T, dtype=torch.bool)
    for k in range(alpha.shape[-1]):
        t_prev[..., k] = T
        t_incl = T * (1.0 - alpha[..., k])
        if cutoff == "soft":
            T = t_incl
        else:
            live = live & (t_incl > TRANSMITTANCE_EPS)
            take[..., k] = live
            T = torch.where(live, t_incl, T)
    if cutoff == "soft":
        return alpha * t_prev, None, t_prev, T[..., None]
    return alpha * t_prev * take.to(alpha.dtype), take, t_prev, T[..., None]


def _median_update(med, zk, t_prev, w):
    """The depth of the last composited pair with T_prev > 0.5 (the
    reference 2DGS median rule). med [A, P, 1], zk [A, 1, K]."""
    sel = (t_prev > 0.5) & (w > 0.0)
    lane1 = torch.arange(1, w.shape[-1] + 1, device=w.device)
    li = torch.where(sel, lane1, torch.zeros_like(lane1))
    m_idx = li.amax(dim=-1, keepdim=True)  # [A, P, 1]
    zpick = torch.gather(zk.expand(w.shape), -1,
                         torch.clamp(m_idx - 1, min=0))
    return torch.where(m_idx > 0, zpick, med)


# ---------------------------------------------------------------------------
# B5: tile forward (csrc/raster_fwd_2dgs.cu)
# ---------------------------------------------------------------------------


def _fwd_2dgs_plain(S, starts, masks, cfg: V2Cfg, zch: int,
                    with_counts: bool = False):
    """Plain version of the 2DGS tile-forward kernel: over the chunk index,
    vectorised across tiles a group at a time (raster_v2._tile_walk).
    Returns [n_tiles, P, CB + 3]: colors[CB], alpha, distortion, median.

    With ``with_counts`` it returns (out, counts), where counts holds what
    the kernels do on these inputs, per (pair, pixel), as raster_v2's
    _fwd_plain counts them: "evaluated", "tested" and "composited" pairs,
    and "composited_uv", the composited pairs whose sigma comes from the
    UV Gaussian (the backward's longer branch)."""
    dev = S.device
    nT, P, CB = cfg.n_tiles, cfg.pixels, cfg.channels
    off, end, c0, c1, px, py, lane, group = rv._tile_walk(S, starts, masks,
                                                          cfg)
    out = torch.empty((nT, P, cfg.chp), dtype=torch.float32, device=dev)
    zrow = _ACOL + zch
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in (
        "evaluated", "tested", "composited", "composited_uv")}
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((n, P, CB), dtype=torch.float32, device=dev)
        accA = torch.zeros((n, P, 1), dtype=torch.float32, device=dev)
        dist = torch.zeros((n, P, 1), dtype=torch.float32, device=dev)
        med = torch.zeros((n, P, 1), dtype=torch.float32, device=dev)
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
            inr = ((cols >= off[sl][idx, None])
                   & (cols < end[sl][idx, None]))[:, None, :]
            pr = _chunk_pair_2dgs(chunk, px[sl][idx][:, :, None],
                                  py[sl][idx][:, :, None], inr)
            w, take, t_prev, t_new = _composite_seq(pr["alpha"], T[idx],
                                                    cfg.cutoff,
                                                    cfg.log_composite)
            if with_counts:
                valid = pr["valid"]
                if take is None:
                    comp, seen = valid, inr.expand_as(valid)
                else:  # up to the first valid pair that is not composited
                    comp = valid & take
                    stop = (valid & ~take).to(torch.int32)
                    seen = inr & ((torch.cumsum(stop, dim=-1) - stop) == 0)
                counts["evaluated"] += seen.sum()
                counts["tested"] += (seen & valid).sum()
                counts["composited"] += comp.sum()
                counts["composited_uv"] += (comp & pr["b3"]).sum()
            acc[idx] += torch.einsum("apk,cak->apc", w,
                                     chunk[_ACOL:_ACOL + CB])
            zk = chunk[zrow][:, None, :]
            wz = w * zk
            A_i = accA[idx] + torch.cumsum(wz, dim=-1) - wz
            dist[idx] += (2.0 * (wz * (1.0 - t_prev) - w * A_i)).sum(
                -1, keepdim=True)
            accA[idx] += wz.sum(-1, keepdim=True)
            med[idx] = _median_update(med[idx], zk, t_prev, w)
            T[idx] = t_new
        out[sl, :, :CB] = acc
        out[sl, :, CB] = 1.0 - T[..., 0]
        out[sl, :, CB + 1] = dist[..., 0]
        out[sl, :, CB + 2] = med[..., 0]
    if with_counts:
        return out, {k: int(v) for k, v in counts.items()}
    return out


def _check_tile_args(name, S, starts, masks, cfg: V2Cfg, zch: int):
    if cfg.n_attr != 12 + cfg.channels or cfg.cull or cfg.extra_out != 2:
        raise ValueError(f"{name}: not a 2DGS configuration (cfg_2dgs)")
    if S.shape != (cfg.d_s, cfg.cap) or starts.shape != (cfg.n_tiles_v + 1,) \
            or masks.shape != (cfg.n_tiles,):
        raise ValueError(f"{name}: S, starts or masks has the wrong shape")
    if cfg.cutoff not in ("exact", "soft"):
        raise ValueError(f"unknown cutoff {cfg.cutoff!r}")
    if not 0 <= zch < cfg.channels - 3:
        raise ValueError(f"{name}: depth channel {zch} outside the user "
                         f"channels of {cfg.channels}")


def _check_cuda_tile_args(name, S, starts, masks, cfg: V2Cfg):
    if cfg.channels > MAX_CHANNELS:
        raise NotImplementedError(
            f"{name}: the 2DGS tile kernels take at most {MAX_CHANNELS} "
            f"channels (user channels + depth + 3 normals), got "
            f"{cfg.channels}")
    if cfg.pixels > 1024:
        raise ValueError("tile_size above 32 does not fit one CUDA block")
    dev = S.device
    rv._check_cuda(f"{name} S", S, torch.float32, dev)
    rv._check_cuda(f"{name} starts", starts, torch.int32, dev)
    rv._check_cuda(f"{name} masks", masks, torch.int32, dev)


def raster_fwd_2dgs(S, starts, masks, cfg: V2Cfg, zch: int, order=None):
    """Sorted 2DGS table -> per-tile outputs [n_tiles, P, CB + 3]: colors
    (the CB composited channels), alpha = 1 - T_final, the distortion and
    the median depth. ``zch`` is the depth's channel; ``masks`` int32
    [n_tiles], 0 disables a tile; ``order`` the blocks' tile order (index
    order if None, as the path runs it: B6 takes no order, and on an H100
    at the 1M scene rv.run_order's longest-run-first order saves B5 about
    0.04 ms against an argsort of 0.11-0.14 ms, chip_smoke.py's
    b5_order)."""
    _check_tile_args("raster_fwd_2dgs", S, starts, masks, cfg, zch)
    if rv._on_cpu(S, "raster_fwd_2dgs"):
        return _fwd_2dgs_plain(S, starts, masks, cfg, zch)
    _check_cuda_tile_args("raster_fwd_2dgs", S, starts, masks, cfg)
    if order is not None:
        if order.shape != (cfg.n_tiles,):
            raise ValueError("raster_fwd_2dgs: order has the wrong shape")
        rv._check_cuda("raster_fwd_2dgs order", order, torch.int32,
                       S.device)
    out = torch.empty((cfg.n_tiles, cfg.pixels, cfg.chp),
                      dtype=torch.float32, device=S.device)
    err = native.lib().gsc_raster_fwd_2dgs(
        S.data_ptr(), cfg.cap, starts.data_ptr(), masks.data_ptr(),
        0 if order is None else order.data_ptr(), cfg.n_tiles,
        cfg.tile_width, cfg.tile_height, cfg.tile_size,
        cfg.channels, zch, int(cfg.cutoff == "soft"),
        int(cfg.log_composite), out.data_ptr(), rv._stream(),
    )
    native.check(err, "gsc_raster_fwd_2dgs")
    rv._count_launch("raster_fwd_2dgs", [(cfg.log_composite, "_log")])
    return out


# ---------------------------------------------------------------------------
# B6: tile backward (csrc/raster_bwd_2dgs.cu)
# ---------------------------------------------------------------------------


def bwd_branches(cfg: V2Cfg):
    """B6's branches, for _count_launch and launch_keys."""
    return [(cfg.log_composite, "_log"), (cfg.absgrad, "_absgrad")]


def _bwd_2dgs_plain(S, starts, masks, tiles, v_tiles, cfg: V2Cfg, zch: int):
    """Plain version of the 2DGS tile-backward kernel: the JAX package's
    hand-derived VJP (``_bwd_kernel_2dgs``) over the chunk index,
    vectorised across tiles as ``_fwd_2dgs_plain`` is. Returns the
    gradient rows [12 + CB (+ 2 with cfg.absgrad), cap] in S's column
    order; columns no tile reaches stay zero."""
    dev = S.device
    nT, P, CB = cfg.n_tiles, cfg.pixels, cfg.channels
    off, end, c0, c1, px, py, lane, group = rv._tile_walk(S, starts, masks,
                                                          cfg)
    gbuf = torch.zeros((cfg.d_g(cfg.absgrad), cfg.cap), dtype=torch.float32,
                       device=dev)
    zero = torch.zeros((), device=dev)
    zrow = _ACOL + zch
    for g0 in range(0, nT, group):
        sl = slice(g0, min(nT, g0 + group))
        n = sl.stop - sl.start
        T = torch.ones((n, P, 1), dtype=torch.float32, device=dev)
        accA = torch.zeros((n, P, 1), dtype=torch.float32, device=dev)
        v_c = v_tiles[sl, :, :CB]
        v_a = v_tiles[sl, :, CB:CB + 1]
        v_d = v_tiles[sl, :, CB + 1:CB + 2]
        c_out = tiles[sl]
        t_final = 1.0 - c_out[:, :, CB:CB + 1]
        wz_total = c_out[:, :, zch:zch + 1]
        # the suffix seed: the colour part sums to <out, v_c>, the
        # distortion part to 2 v_d dist_out
        q = ((c_out[:, :, :CB] * v_c).sum(-1, keepdim=True)
             + 2.0 * v_d * c_out[:, :, CB + 1:CB + 2])
        nch = c1[sl] - c0[sl]
        for j in range(int(nch.max()) if n else 0):
            live = (nch > j) & (T.amax(dim=(1, 2)) > TRANSMITTANCE_EPS)
            idx = live.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            chunk = S[:, cols]  # [d_s, A, K]
            inr = (cols >= off[sl][idx, None]) & (cols < end[sl][idx, None])
            pxa = px[sl][idx][:, :, None]
            pya = py[sl][idx][:, :, None]
            pr = _chunk_pair_2dgs(chunk, pxa, pya, inr[:, None, :])
            alpha = pr["alpha"]
            w, m, t_prev, t_new = _composite_seq(alpha, T[idx], cfg.cutoff,
                                                 cfg.log_composite)
            zk = chunk[zrow][:, None, :]
            wz = w * zk
            A_i = accA[idx] + torch.cumsum(wz, dim=-1) - wz
            P_i = 1.0 - t_prev
            t_fin = t_final[idx]
            # T_incl in product form in both scans, as in the JAX kernel
            S_i = torch.clamp(t_prev * (1.0 - alpha) - t_fin, min=0.0)
            SZ_i = wz_total[idx] - A_i - wz
            vc = v_c[idx]
            vd = v_d[idx]
            Gpk = torch.einsum("apc,cak->apk", vc, chunk[_ACOL:_ACOL + CB])
            Dw = 2.0 * vd * (zk * P_i - A_i + SZ_i - zk * S_i)
            GD = Gpk + Dw
            u = w * GD
            s = q[idx] - torch.cumsum(u, dim=-1)  # the suffix after k
            oma = 1.0 - alpha
            inv_oma = 1.0 / torch.where(oma > 0, oma, torch.ones_like(oma))
            v_alpha = (t_prev * GD - s * inv_oma
                       + v_a[idx] * t_fin * inv_oma)
            if m is not None:
                v_alpha = v_alpha * m.to(v_alpha.dtype)
            dvalid = (pr["valid"] & ~pr["clamped"]).to(alpha.dtype)
            v_sig = -alpha * v_alpha * dvalid  # [A, P, K]

            # sigma = 0.5 * min(gw3d, gw2d): the branch that set it
            b3 = pr["b3"].to(v_sig.dtype)
            v_sig3 = v_sig * b3
            v_sig2 = v_sig * (1.0 - b3)
            rows = [None] * cfg.d_g(cfg.absgrad)
            # the screen-space filter branch -> means2d
            vx_pix = FILTER_INV_SQUARE * pr["dx"] * v_sig2
            vy_pix = FILTER_INV_SQUARE * pr["dy"] * v_sig2
            rows[_AX] = vx_pix.sum(1)
            rows[_AY] = vy_pix.sum(1)
            if cfg.absgrad:  # that branch's |per-pixel| terms
                rows[_ACOL + CB] = vx_pix.abs().sum(1)
                rows[_ACOL + CB + 1] = vy_pix.abs().sum(1)
            # the UV branch -> the ray transform, through the cross product
            su, sv, inv_cz = pr["su"], pr["sv"], pr["inv_cz"]
            v_su = su * v_sig3
            v_sv = sv * v_sig3
            nzm = pr["nz"].to(v_sig.dtype)
            v_cx = v_su * inv_cz * nzm
            v_cy = v_sv * inv_cz * nzm
            v_cz = -(su * v_su + sv * v_sv) * inv_cz * nzm
            hu_x, hu_y, hu_z = pr["hu"]
            hv_x, hv_y, hv_z = pr["hv"]
            v_hu = (hv_y * v_cz - hv_z * v_cy, hv_z * v_cx - hv_x * v_cz,
                    hv_x * v_cy - hv_y * v_cx)
            v_hv = (v_cy * hu_z - v_cz * hu_y, v_cz * hu_x - v_cx * hu_z,
                    v_cx * hu_y - v_cy * hu_x)
            for c in range(3):
                rows[_AM + c] = (-v_hu[c]).sum(1)
                rows[_AM + 3 + c] = (-v_hv[c]).sum(1)
                rows[_AM + 6 + c] = (pxa * v_hu[c] + pya * v_hv[c]).sum(1)
            op_k = chunk[_AOP]
            rows[_AOP] = torch.where(
                op_k > 0.0,
                -v_sig.sum(1) / torch.where(op_k > 0.0, op_k,
                                            torch.ones_like(op_k)),
                zero)
            # v_color[ch, k] = sum_p w v_c,ch; the depth channel adds the
            # distortion's z-chain 2 v_d w (P - S)
            vcol = torch.einsum("apc,apk->cak", vc, w)
            vcol[zch] = vcol[zch] + (2.0 * vd * w * (P_i - S_i)).sum(1)
            rows[_ACOL:_ACOL + CB] = list(vcol.unbind(0))
            vals = torch.stack(rows)  # [d_g, A, K]
            gbuf[:, cols[inr]] = vals[:, inr]
            T[idx] = t_new
            q[idx] = s[..., -1:]
            accA[idx] = accA[idx] + wz.sum(-1, keepdim=True)
    return gbuf


def bwd_build(channels: int, tile_size: int, absgrad: bool = False) -> dict:
    """The build of B6 that a launch at these shapes takes
    (csrc/raster_bwd_2dgs.cuh ``launch``): the channels' template bound
    "cbm", pixels a thread "ppt", "absgrad" and the launch bounds
    "max_threads" and "min_blocks" (the 128-thread build for 6 blocks an SM
    at bounds up to 8 and tiles of up to 128 threads, else the one bounded
    by tile 32)."""
    cbm = next(b for b in (4, 8, 16, 32, 64, 128) if channels <= b)
    ppt = bwd_pixels_per_thread(channels)
    n_warps, _, _ = rv._warp_layout(tile_size, ppt)
    small = cbm <= 8 and n_warps * 32 <= 128
    return dict(cbm=cbm, ppt=ppt, absgrad=bool(absgrad),
                max_threads=128 if small else 1024 // ppt,
                min_blocks=6 if small else 1)


FWD_SMALL_MIN_BLOCKS = 8  # raster_fwd_2dgs.cu kSmallMinBlocks


def fwd_build(channels: int, tile_size: int) -> dict:
    """The build of B5 that a launch at these shapes takes
    (csrc/raster_fwd_2dgs.cu ``launch``): the channels' template bound
    "cbm", pixels a thread "ppt" (2 up to 32 channels, else 1), the block's
    "threads" and the launch bounds "max_threads" and "min_blocks" (at
    bounds 4 and 8 up to 128 threads, 128 for FWD_SMALL_MIN_BLOCKS blocks
    an SM; at 64 and 128 channels 256 up to 256 threads; else the tile-32
    bound, 1024 / ppt)."""
    cbm = next(b for b in (4, 8, 16, 32, 64, 128) if channels <= b)
    ppt = bwd_pixels_per_thread(channels)
    threads = rv._warp_layout(tile_size, ppt)[0] * 32
    min_blocks = 1
    if cbm <= 8 and threads <= 128:
        max_threads, min_blocks = 128, FWD_SMALL_MIN_BLOCKS
    elif cbm >= 64 and threads <= 256:
        max_threads = 256
    else:
        max_threads = 1024 // ppt
    return dict(cbm=cbm, ppt=ppt, threads=threads, max_threads=max_threads,
                min_blocks=min_blocks)


def _pair_regions(chunk):
    """The candidate region of each pair that B5 and B6 share
    (csrc/regions.cuh ``surfel_region``, formed once a chunk and tested
    against each pixel before its pair math): ``chunk`` [d_s, ...] sorted
    rows -> float32 (ecx, ecy, qa, qb, qc, bound, r2) [...]. A pixel (px,
    py) is a candidate when qa ex^2 + 2 qb ex ey + qc ey^2 <= bound (ex = px -
    ecx, ey = py - ecy) or (x - px)^2 + (y - py)^2 <= r2; outside both it
    cannot reach alpha >= 1/255. A pair seen nearly edge on (FLAT_RATIO)
    or reaching the camera's side gets no bound: qa = qb = qc = 0, every
    pixel a candidate. Formed in float64 from the float32 rows, as the
    kernel does."""
    d = chunk.double()
    op32 = chunk[_AOP]
    Lm = 1.01 * torch.clamp(torch.log(255.0 * d[_AOP]), min=0.0) + 0.01
    rf = torch.sqrt(Lm) + 0.1
    r2 = (rf * rf).float()
    rho2 = 2.0 * Lm
    m = [d[_AM + i] for i in range(9)]

    def Q(a, b):
        return (rho2 * (m[3 * a] * m[3 * b] + m[3 * a + 1] * m[3 * b + 1])
                - m[3 * a + 2] * m[3 * b + 2])

    q22 = Q(2, 2)
    scale = rho2 * (m[6] * m[6] + m[7] * m[7]) + m[8] * m[8]
    cx, cy = Q(0, 2) / q22, Q(1, 2) / q22
    s00 = Q(0, 0) / -q22 + cx * cx
    s11 = Q(1, 1) / -q22 + cy * cy
    s01 = Q(0, 1) / -q22 + cx * cy
    iso = 0.21 + 1e-3 * (s00 + s11)
    a00, a11, a01 = 1.05 * s00 + iso, 1.05 * s11 + iso, 1.05 * s01
    det = a00 * a11 - a01 * a01
    # the camera nearly in the surfel's plane: M's rows about the centre
    w = torch.stack(m[6:9])
    u = torch.stack(m[0:3]) - cx * w
    v = torch.stack(m[3:6]) - cy * w
    det_m = (u * torch.linalg.cross(v, w, dim=0)).sum(0)
    sq = u * u + v * v + w * w  # M's columns about the centre
    flat = det_m.abs() < FLAT_RATIO * torch.sqrt(sq[0] * sq[1] * sq[2])
    ok = ((q22 < -1e-6 * scale) & ~flat & (det > 0.0) & (a00 > 0.0)
          & (a11 > 0.0))
    zero = torch.zeros((), dtype=torch.float64, device=chunk.device)
    f32 = [torch.where(ok, v, zero).float() for v in (
        cx, cy, a11 / det, -a01 / det, a00 / det)]
    empty = ~(op32 >= ALPHA_THRESHOLD)
    bound = torch.where(empty, -1.0, 1.0).to(torch.float32)
    r2 = torch.where(empty, torch.full_like(r2, -1.0), r2)
    return (*f32, bound, r2)


def _pair_boxes(chunk, regions):
    """B5's box of each pair's candidate region (csrc/regions.cuh
    ``surfel_box``, which B5's warps test their cells against before the
    pixels' test): ``chunk`` [d_s, ...] sorted rows and ``regions``
    (_pair_regions) -> float32 (x0, x1, y0, y1) [...]. The disk's square
    joined with the box of the float form's ellipse, half widths
    sqrt(diag(Qf^-1)), each * 1.001 + 0.01 px; empty (x0 = +inf) where no
    pixel composites, unbounded where the ellipse is. Formed in float64
    from the float32 values, as the kernel does."""
    ecx, ecy, qa, qb, qc, bound, r2 = (v.double() for v in regions)
    det = qa * qc - qb * qb
    rb = torch.sqrt(r2) * 1.001 + 0.01
    hx = torch.sqrt(qc / det) * 1.001 + 0.01
    hy = torch.sqrt(qa / det) * 1.001 + 0.01
    mx, my = chunk[_AX].double(), chunk[_AY].double()
    box = [torch.fmin(mx - rb, ecx - hx), torch.fmax(mx + rb, ecx + hx),
           torch.fmin(my - rb, ecy - hy), torch.fmax(my + rb, ecy + hy)]
    unbounded = ~(det > 0.0)
    empty = ~(bound > 0.0)
    out = []
    for i, v in enumerate(box):
        lo = i % 2 == 0
        v = torch.where(unbounded, -math.inf if lo else math.inf, v)
        v = torch.where(empty, math.inf if lo else -math.inf, v)
        out.append(v.float())
    return tuple(out)


def _candidates(chunk, px, py):
    """Which (pair, pixel) slots B5 and B6 evaluate (B5 also none past a
    pixel's exact cutoff in a chunk): [A, P, K] from ``chunk``
    [d_s, A, K] and pixel centres [A, P, 1], as the kernel tests them."""
    ecx, ecy, qa, qb, qc, bound, r2 = [v[:, None, :] for v in
                                       _pair_regions(chunk)]
    ex, ey = px - ecx, py - ecy
    dx = chunk[_AX][:, None, :] - px
    dy = chunk[_AY][:, None, :] - py
    qv = qa * ex * ex + 2.0 * qb * ex * ey + qc * ey * ey
    return (qv <= bound) | (dx * dx + dy * dy <= r2)


def _bwd_2dgs_counts(S, starts, masks, cfg: V2Cfg):
    """What B6 does on these inputs: _region_counts_2dgs in B6's layout."""
    return _region_counts_2dgs(S, starts, masks, cfg,
                               bwd_pixels_per_thread(cfg.channels))


def _fwd_2dgs_counts(S, starts, masks, cfg: V2Cfg):
    """What B5 does on these inputs: _region_counts_2dgs in B5's layout,
    with its warps' test of the regions' boxes."""
    return _region_counts_2dgs(S, starts, masks, cfg, fwd_build(
        cfg.channels, cfg.tile_size)["ppt"], boxes=True)


def _region_counts_2dgs(S, starts, masks, cfg: V2Cfg, ppt: int,
                        boxes: bool = False):
    """What the 2DGS tile kernels do on these inputs, from the plain walk
    (a tile stops when every pixel has T <= 1e-4 at a chunk's start: the
    backward's rule, and the forward's, whose exact cutoff leaves every
    pixel's T above 1e-4), in the layout of ``ppt`` neighbours of one tile
    row a lane, and a warp the 32 lanes of a cell 8 pixels wide, the cells
    row-major. Returns a dict of
      "run": int64 [n_tiles], rows of the tile's run that the walk reaches;
      "pairs": int64 [n_tiles], pairs that at least one pixel composited;
      "slots": int64 [n_tiles], composited (pair, pixel) slots;
      "evaluated_slots": the (pair, pixel) slots walked;
      "candidate_slots": those inside the pair's candidate region
        (_candidates), the ones B5 and B6 evaluate; with ``boxes``, also
        in a warp whose cell meets the region's box (_pair_boxes, B5's
        test);
      "missed_slots": slots that pass the alpha test outside them (0: the
        regions hold every pixel that passes);
      "pair_warp_cells" (with ``boxes``): the (pair, warp) whose cell
        meets the box, the ones that test their pixels;
      "pair_warp_candidates": (pair, warp) with at least one candidate,
        the ones that evaluate the pair;
      "pair_warp_hits": (pair, warp) with at least one composited pixel,
        each a warp reduction (or the ballot shortcut) in the kernel;
      "single_lane_hits": those where exactly one lane composited the
        pair (the ballot shortcut's);
      "warps_per_tile": the warps that cover a tile's pixels."""
    dev = S.device
    nT, P = cfg.n_tiles, cfg.pixels
    off, end, c0, c1, px, py, lane, group = rv._tile_walk(S, starts, masks,
                                                          cfg)
    n_warps, _, lane_of = rv._warp_layout(cfg.tile_size, ppt)
    lane_of = lane_of.to(dev)
    warp_of = torch.div(lane_of, 32, rounding_mode="floor")
    cells = [v.to(dev) for v in rv._cell_bounds(cfg, ppt)]
    i64 = dict(dtype=torch.int64, device=dev)
    counts = {k: torch.zeros(nT, **i64) for k in ("run", "pairs", "slots")}
    totals = {k: torch.zeros((), **i64) for k in (
        "evaluated_slots", "candidate_slots", "missed_slots",
        "pair_warp_candidates", "pair_warp_hits", "single_lane_hits",
        "pair_warp_cells")}

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
            cols = ((c0[sl][idx] + j) * K)[:, None] + lane  # [A, K]
            inr = (cols >= off[sl][idx, None]) & (cols < end[sl][idx, None])
            chunk = S[:, cols]
            pxa = px[sl][idx][:, :, None]
            pya = py[sl][idx][:, :, None]
            pr = _chunk_pair_2dgs(chunk, pxa, pya, inr[:, None, :])
            _, m, _, t_new = _composite_seq(pr["alpha"], T[idx], cfg.cutoff,
                                            cfg.log_composite)
            comp = pr["valid"] if m is None else pr["valid"] & m  # [A, P, K]
            walked = inr[:, None, :].expand_as(comp)
            cand = _candidates(chunk, pxa, pya) & walked
            t = idx + g0
            if boxes:
                x0, x1, y0, y1 = (v[:, None, :] for v in _pair_boxes(
                    chunk, _pair_regions(chunk)))
                xlo, xhi, ylo, yhi = (v[t][:, :, None] for v in cells)
                box = ((x0 <= xhi) & (x1 >= xlo) & (y0 <= yhi) & (y1 >= ylo)
                       & inr[:, None, :])  # [A, n_warps, K]
                cand = cand & box[:, warp_of]
                totals["pair_warp_cells"] += box.sum()
            counts["run"][t] += inr.sum(-1)
            counts["pairs"][t] += comp.any(1).sum(-1)
            counts["slots"][t] += comp.sum((1, 2))
            totals["evaluated_slots"] += walked.sum()
            totals["candidate_slots"] += cand.sum()
            totals["missed_slots"] += (pr["valid"] & ~cand).sum()
            totals["pair_warp_candidates"] += (by_warp(cand) > 0).sum()
            lanes_hit = by_warp(comp)
            totals["pair_warp_hits"] += (lanes_hit > 0).sum()
            totals["single_lane_hits"] += (lanes_hit == 1).sum()
            T[idx] = t_new
    if not boxes:
        del totals["pair_warp_cells"]
    return dict(**counts, **{k: int(v) for k, v in totals.items()},
                warps_per_tile=n_warps)


def raster_bwd_2dgs(S, starts, masks, tiles, v_tiles, cfg: V2Cfg, zch: int):
    """2DGS tile backward: the sorted table, the forward's tile outputs and
    their cotangents [n_tiles, P, CB + 3] -> per-intersection gradient rows
    [12 + CB, cap] (x, y, m00..m22, op, colors[CB], and with cfg.absgrad
    the filter branch's sums of |x| and |y| terms), column j holding the
    gradient of S's column j. The median's cotangent is not read (the
    median carries no gradient). Columns no tile reaches are zero."""
    _check_tile_args("raster_bwd_2dgs", S, starts, masks, cfg, zch)
    tshape = (cfg.n_tiles, cfg.pixels, cfg.chp)
    if tiles.shape != tshape or v_tiles.shape != tshape:
        raise ValueError("raster_bwd_2dgs: tiles or v_tiles has the wrong "
                         "shape")
    if rv._on_cpu(S, "raster_bwd_2dgs"):
        return _bwd_2dgs_plain(S, starts, masks, tiles, v_tiles, cfg, zch)
    _check_cuda_tile_args("raster_bwd_2dgs", S, starts, masks, cfg)
    dev = S.device
    rv._check_cuda("raster_bwd_2dgs tiles", tiles, torch.float32, dev)
    rv._check_cuda("raster_bwd_2dgs v_tiles", v_tiles, torch.float32, dev)
    gbuf = torch.zeros((cfg.d_g(cfg.absgrad), cfg.cap), dtype=torch.float32,
                       device=dev)
    err = native.lib().gsc_raster_bwd_2dgs(
        S.data_ptr(), cfg.cap, starts.data_ptr(), masks.data_ptr(),
        tiles.data_ptr(), v_tiles.data_ptr(), cfg.n_tiles, cfg.tile_width,
        cfg.tile_height, cfg.tile_size, cfg.channels, zch,
        int(cfg.cutoff == "soft"), int(cfg.absgrad), int(cfg.log_composite),
        gbuf.data_ptr(), rv._stream(),
    )
    native.check(err, "gsc_raster_bwd_2dgs")
    rv._count_launch("raster_bwd_2dgs", bwd_branches(cfg))
    return gbuf


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _build_sorted_2dgs(cfg: V2Cfg, means2d, transforms, colors, opacities,
                       depths, radii) -> rv.Binning:
    return rv._build_sorted_generic(
        cfg, means2d,
        _attr_rows_2dgs(cfg, means2d, transforms, colors, opacities),
        depths, radii)


class _RasterCore2DGS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, zch, means2d, transforms, colors, opacities,
                depths, radii, masks, ag_probe):
        del ag_probe  # its gradient carries absgrad out of the backward
        b = _build_sorted_2dgs(cfg, means2d, transforms, colors, opacities,
                               depths, radii)
        tiles = raster_fwd_2dgs(b.S, b.starts, masks, cfg, zch)
        ctx.mark_non_differentiable(b.n_isects)
        ctx.cfg, ctx.zch = cfg, zch
        ctx.save_for_backward(b.S, b.starts, masks, tiles, b.cum, b.order,
                              b.perm, b.n_isects)
        return tiles, b.n_isects

    @staticmethod
    def backward(ctx, v_tiles, _):
        S, starts, masks, tiles, cum, order, perm, n_isects = \
            ctx.saved_tensors
        cfg = ctx.cfg
        gbuf = raster_bwd_2dgs(S, starts, masks, tiles,
                               v_tiles.to(torch.float32).contiguous(), cfg,
                               ctx.zch)
        g = rv._reduce_grads(gbuf, perm, cum, order, n_isects).T
        C, N, CB = cfg.C, cfg.n, cfg.channels
        v_ag = (g[:, _ACOL + CB:_ACOL + CB + 2].reshape(C, N, 2)
                if cfg.absgrad else None)
        # the depths are the sort key only: no gradient (as in JAX)
        return (None, None, g[:, _AX:_AY + 1].reshape(C, N, 2),
                g[:, _AM:_AM + 9].reshape(C, N, 3, 3),
                g[:, _ACOL:_ACOL + CB].reshape(C, N, CB),
                g[:, _AOP].reshape(C, N), None, None, None, v_ag)


def rasterize_to_pixels_2dgs_v2(
    means2d,  # [C, N, 2]
    ray_transforms,  # [C, N, 3, 3]
    colors,  # [C, N, ch] (the LAST channel is the depth)
    opacities,  # [C, N]
    normals,  # [C, N, 3]
    depths,  # [C, N] (the sort key)
    radii,  # [C, N] or [C, N, 2] int32
    width: int,
    height: int,
    tile_size: int = 16,
    isect_capacity: int = 1 << 20,
    backgrounds=None,  # [C, ch]
    masks=None,  # [C, TH, TW] bool
    log_composite: bool = False,
    absgrad_probe=None,  # [C, N, 2] zeros
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, dict]:
    """Differentiable fused 2DGS rasterization.

    Returns (colors [C,H,W,ch], alphas [C,H,W,1], normals [C,H,W,3],
    distort [C,H,W,1], median [C,H,W,1], meta) with meta["n_isects"] =
    min(total intersections, capacity) as an int32 [1] tensor; a list past
    the capacity truncates its deepest intersections, as in the JAX package.
    The capacity is ``isect_capacity`` rounded up to a multiple of 4096.
    The median depth carries no gradient; the background is added outside
    the kernel. ``log_composite`` selects the log-space transmittance
    scan. With ``absgrad_probe`` ([C, N, 2], read by nothing but autograd)
    the probe's gradient is each surfel's sum, over its intersections and
    their tiles' pixels, of |2 dx v_sig| and |2 dy v_sig| where the screen
    filter set sigma (that branch's per-pixel means2d terms)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    means2d, ray_transforms = f32(means2d), f32(ray_transforms)
    colors, opacities, normals = f32(colors), f32(opacities), f32(normals)
    depths = f32(depths)
    radii = torch.as_tensor(radii, device=dev).to(torch.int32).contiguous()
    C, N, CH = colors.shape
    zch = CH - 1  # the depth rides as the last user channel
    CB = CH + 3
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    cap = -(-isect_capacity // CAP_BLOCK) * CAP_BLOCK
    cfg = cfg_2dgs(C, TW, TH, tile_size, CB, cap, N,
                   log_composite=bool(log_composite),
                   absgrad=absgrad_probe is not None)
    if masks is None:
        masks_arr = torch.ones(cfg.n_tiles, dtype=torch.int32, device=dev)
    else:
        masks_arr = torch.as_tensor(masks, device=dev).reshape(
            cfg.n_tiles).to(torch.int32)
    colors_full = torch.cat([colors, normals], dim=-1).contiguous()
    tiles, n_isects = _RasterCore2DGS.apply(
        cfg, zch, means2d, ray_transforms, colors_full, opacities, depths,
        radii, masks_arr, absgrad_probe)

    ts = tile_size
    img = tiles.reshape(C, TH, TW, ts, ts, cfg.chp).permute(0, 1, 3, 2, 4, 5)
    img = img.reshape(C, TH * ts, TW * ts, cfg.chp)[:, :height, :width, :]
    colors_img = img[..., :CH]
    normals_img = img[..., CH:CH + 3]
    alphas = img[..., CB:CB + 1]
    distort = img[..., CB + 1:CB + 2]
    median = img[..., CB + 2:CB + 3].detach()
    if backgrounds is not None:
        colors_img = colors_img + (1.0 - alphas) * f32(backgrounds)[
            :, None, None, :]
    meta = {"n_isects": n_isects, "tile_width": TW, "tile_height": TH}
    return colors_img, alphas, normals_img, distort, median, meta
