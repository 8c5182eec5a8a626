#!/usr/bin/env python3
"""Smoke run of gscodec_studio_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one JSON line each with its own ``seconds``:
  device    nvidia-smi's name and power limit, torch and CUDA versions;
  build     the nvcc build of csrc/*.cu (route: plain-C .so + ctypes);
  kernels   each kernel against its plain PyTorch version on the card: a
            20k-Gaussian scene at 320x240, tile 16 and 32, both cutoffs;
  serve     the committed checkpoint results/garden_ab_f32/splats_final.npz
            (120k Gaussians, SH 3) rendered from 8 orbit cameras at
            1297x840 through utils.ply_render.render_splats, and its first
            view's kernels held against their plain versions;
  scene_1m  the 1M-Gaussian SH-3 synthetic scene at 1297x840: tile 16 and
            32 with the exact cutoff, tile 16 with the soft one; render
            time, per-kernel time, plain time, library time and the bound
            of each kernel, with each kernel held against its plain version.
Then a line {"kernels": [...]} with each kernel's numbers, the card's name
and power limit, and the result line. Any failed check raises, and the
script exits non-zero without the result line.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "results" / "garden_ab_f32" / "splats_final.npz"
WIDTH, HEIGHT = 1297, 840
N_1M = 1_000_000
N_SMALL = 20_000
FWD_TOL = 1e-4  # kernel vs plain forward, max abs on colors and alpha
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# raster_fwd's float32 operations per (pair, pixel), from csrc/raster_fwd.cu
# with the per-Gaussian 0.5*ca and 0.5*cc hoisted: sigma and alpha (dx, dy,
# three products, the three-term sum, exp, op*exp, min, two tests) for each
# evaluated pair; 1 - alpha, T*(1 - alpha) and, exact only, its test for
# each pair that passes the alpha test; the weight and CH multiply-adds for
# each composited pair.
FWD_OPS_EVALUATED = 15
FWD_OPS_TESTED = {"exact": 3, "soft": 2}

KERNELS = {
    "pack_rows": dict(source="gscodec_studio_tpu_torch/csrc/pack.cu",
                      replaces="gscodec_studio_tpu/ops/raster_v2.py:324"),
    "expand": dict(source="gscodec_studio_tpu_torch/csrc/expand.cu",
                   replaces="gscodec_studio_tpu/ops/raster_v2.py:424"),
    "raster_fwd": dict(source="gscodec_studio_tpu_torch/csrc/raster_fwd.cu",
                       replaces="gscodec_studio_tpu/ops/raster_v2.py:883"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Stages:
    """One binning + forward pass, keeping every kernel's inputs and
    outputs so each can be re-run, timed and compared."""

    def __init__(self, rv, cfg, means2d, conics, colors, opacities, depths,
                 radii, masks):
        self.rv, self.cfg, self.masks = rv, cfg, masks
        self.b = rv._build_sorted(cfg, means2d, conics, colors, opacities,
                                  depths, radii)
        self.attr_rows = rv._attr_rows(cfg, means2d, conics, colors,
                                       opacities)
        self.row_list = list(self.b.rows)
        self.out = rv.raster_fwd(self.b.S, self.b.starts, masks, cfg)

    def compare(self, errs):
        """Hold each kernel's output against its plain version on the same
        inputs. Pack must match bit for bit; expansion too, except pairs on
        the ellipse-cull bound, which are counted; forward within FWD_TOL."""
        rv, cfg = self.rv, self.cfg
        res = {}
        b = self.b
        table_p = rv._pack_rows_plain(self.attr_rows, cfg.n_attr, b.order)
        S_p = rv._pack_rows_plain(self.row_list, cfg.d_s, b.perm)
        if not (torch.equal(table_p, b.table) and torch.equal(S_p, b.S)):
            raise AssertionError("pack_rows kernel differs from its plain "
                                 "version")
        errs["pack_rows"] = max(errs.get("pack_rows", 0.0), 0.0)

        tile_p, rows_p = rv._expand_plain(b.cum, b.base, b.nx,
                                          b.table, b.n_isects, cfg)
        if not torch.equal(rows_p, b.rows):
            raise AssertionError("expand kernel rows differ from plain")
        diff = (tile_p != b.tile).nonzero().squeeze(1)
        n_bound = 0
        if diff.numel():
            # a flip is allowed only between a tile and the overflow tile,
            # for a pair whose cull sides agree to float rounding
            lo = torch.minimum(b.tile[diff], tile_p[diff])
            hi = torch.maximum(b.tile[diff], tile_p[diff])
            g = b.rows[cfg.n_attr, diff].to(torch.int64)
            lhs, rhs = rv._cull_lhs_rhs(cfg, lo, b.table, g)
            on_bound = (lhs - rhs).abs() <= 1e-5 * torch.clamp(rhs.abs(),
                                                                 min=1.0)
            if not bool(((hi == cfg.n_tiles) & (lo < cfg.n_tiles)
                         & on_bound).all()):
                raise AssertionError(
                    f"expand kernel keys differ off the cull bound at "
                    f"{diff.numel()} rows")
            n_bound = int(diff.numel())
        errs["expand"] = max(errs.get("expand", 0.0), 0.0)
        res["cull_bound_pairs"] = n_bound

        ref, self.pair_counts = rv._fwd_plain(b.S, b.starts, self.masks,
                                              cfg, with_counts=True)
        err = float((ref - self.out).abs().max())
        if not (math.isfinite(err) and err <= FWD_TOL):
            raise AssertionError(f"raster_fwd max abs err {err} > {FWD_TOL}")
        errs["raster_fwd"] = max(errs.get("raster_fwd", 0.0), err)
        res["fwd_max_abs_err"] = err
        return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gscodec_studio_tpu_torch import native
    from gscodec_studio_tpu_torch.models.splats import from_jax_splats
    from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.rendering import (project_and_shade,
                                                    rasterization)
    from gscodec_studio_tpu_torch.utils.ply_render import (orbit_cameras,
                                                           render_splats)
    from gscodec_studio_tpu_torch.utils.scenes import make_scene

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    t0 = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "seconds": time.perf_counter() - t0})

    # 2. build
    t0 = time.perf_counter()
    so = native.build()
    native.lib()
    log = Path(str(so) + ".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln] if log.exists() else []
    emit({"phase": "build", "library": so.name,
          "nvcc_seconds": native.build_seconds, "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})

    def to_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    def prepared(scene, width, height):
        means, quats, scales, opac, colors, vm, Ks = to_dev(*scene)
        return project_and_shade(means, quats, scales, opac, colors, vm, Ks,
                                 width, height, sh_degree=3)

    def stages_for(prep, width, height, ts, cutoff, cap=None):
        radii, means2d, depths, conics, colors_cn, opac_cn, _ = prep
        C, N = depths.shape
        TW, TH = -(-width // ts), -(-height // ts)
        if cap is None:
            _, _, _, cnt = rv.tile_counts(means2d, radii, ts, TW, TH)
            cap = int(1.2 * int(cnt.sum())) + 1
        cap = -(-cap // rv.CAP_BLOCK) * rv.CAP_BLOCK
        cfg = rv.V2Cfg(C=C, tile_width=TW, tile_height=TH, tile_size=ts,
                       channels=colors_cn.shape[-1], cap=cap, n=N,
                       cutoff=cutoff)
        masks = torch.ones(cfg.n_tiles, dtype=torch.int32, device=dev)
        f = [x.contiguous() for x in (means2d, conics, colors_cn, opac_cn,
                                      depths)]
        return Stages(rv, cfg, *f, radii.contiguous(), masks)

    errs = {}

    # 3. kernels: small scene, every tile size and cutoff
    t0 = time.perf_counter()
    sw, sh = 320, 240
    small = list(make_scene(n=N_SMALL, width=sw, height=sh, seed=1))
    small[6] = small[6].copy()
    small[6][0, 0, 0] = small[6][0, 1, 1] = 1100.0 * sw / WIDTH
    prep_small = prepared(small, sw, sh)
    cases = []
    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            st = stages_for(prep_small, sw, sh, ts, cutoff)
            res = st.compare(errs)
            cases.append(dict(tile_size=ts, cutoff=cutoff,
                              n_isects=int(st.b.n_isects), **res))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "max_abs_err": errs,
          "fwd_tol": FWD_TOL, "seconds": time.perf_counter() - t0})

    # 4. serve: the committed checkpoint through render_splats
    t0 = time.perf_counter()
    with np.load(CHECKPOINT) as z:
        splats = {k: z[k] for k in z.files}
    model = from_jax_splats(splats, device=dev)
    cams = orbit_cameras(splats["means"], n_views=8, width=WIDTH,
                         height=HEIGHT)
    probe = []
    with torch.no_grad():
        means, quats, opac = model.means, model.quats, torch.sigmoid(
            model.opacities)
        scales = torch.exp(model.scales)
        for cam in cams:
            vm = torch.as_tensor(np.linalg.inv(cam["camtoworld"])[None],
                                 device=dev)
            K = torch.as_tensor(cam["K"][None], device=dev)
            prep = project_and_shade(means, quats, scales, opac,
                                     model.sh_coeffs(), vm, K, WIDTH, HEIGHT,
                                     sh_degree=3)
            _, _, _, cnt = rv.tile_counts(prep[1], prep[0], 16,
                                          -(-WIDTH // 16), -(-HEIGHT // 16))
            probe.append(int(cnt.sum()))
    capacity = int(1.2 * max(probe))
    cap_rounded = -(-capacity // rv.CAP_BLOCK) * rv.CAP_BLOCK
    rv.reset_launch_counts()
    outs = render_splats(model, cams, sh_degree=3, isect_capacity=capacity)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        render_splats(model, cams, sh_degree=3, isect_capacity=capacity)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(cams))
    serve_launches = dict(rv.LAUNCHES)
    n_isects = [int(m["n_isects"]) for _, _, m in outs]
    if n_isects != probe or max(n_isects) >= cap_rounded:
        raise AssertionError(f"serve n_isects {n_isects} vs probe {probe}, "
                             f"capacity {cap_rounded}")
    if not all(bool(torch.isfinite(img).all() and torch.isfinite(a).all())
               for img, a, _ in outs):
        raise AssertionError("serve produced non-finite pixels")
    mean_alpha = float(torch.stack([a.mean() for _, a, _ in outs]).mean())
    if not mean_alpha > 0.05:
        raise AssertionError(f"serve mean alpha {mean_alpha} <= 0.05")
    if min(serve_launches.values()) < 1:
        raise AssertionError(f"a kernel did not launch: {serve_launches}")
    # view 0's kernels against their plain versions at the serve shapes
    vm0 = np.linalg.inv(cams[0]["camtoworld"])[None]
    with torch.no_grad():
        prep0 = project_and_shade(
            means, quats, scales, opac, model.sh_coeffs(),
            torch.as_tensor(vm0, device=dev),
            torch.as_tensor(cams[0]["K"][None], device=dev), WIDTH, HEIGHT,
            sh_degree=3)
    serve_check = stages_for(prep0, WIDTH, HEIGHT, 16, "exact",
                             cap=capacity).compare(errs)
    emit({"phase": "serve", "checkpoint": str(CHECKPOINT.relative_to(ROOT)),
          "gaussians": model.num_splats, "views": len(cams),
          "width": WIDTH, "height": HEIGHT, "tile_size": 16,
          "isect_capacity": cap_rounded, "n_isects": n_isects,
          "ms_per_view": times, "mean_alpha": mean_alpha,
          "launches": serve_launches, "view0_check": serve_check,
          "seconds": time.perf_counter() - t0})
    del model, outs, prep0

    # 5. scene_1m: 1M Gaussians, SH 3, one camera
    t0 = time.perf_counter()
    scene = make_scene(n=N_1M, width=WIDTH, height=HEIGHT, seed=0)
    prep_1m = prepared(scene, WIDTH, HEIGHT)
    means, quats, scales, opac, colors, vm, Ks = to_dev(*scene)
    # rows that binning at tile 16 makes under three radius rules: 3-sigma
    # circles, opacity-aware circles, and the opacity-aware ellipses that
    # the path uses (the count before the expansion's ellipse cull)
    binned_rows = {}
    for rule, kw in (("circle_3sigma", {}),
                     ("circle_opacity", dict(opacities=opac)),
                     ("ellipse_opacity", dict(opacities=opac,
                                              elliptical=True))):
        radii, m2d = fully_fused_projection(means, None, quats, scales, vm,
                                            Ks, WIDTH, HEIGHT, **kw)[:2]
        binned_rows[rule] = int(rv.tile_counts(
            m2d, radii, 16, -(-WIDTH // 16), -(-HEIGHT // 16))[3].sum())
    perf = {}
    rows_1m = []
    for ts, cutoff in ((16, "exact"), (32, "exact"), (16, "soft")):
        st = stages_for(prep_1m, WIDTH, HEIGHT, ts, cutoff)
        cfg = st.cfg
        check = st.compare(errs)
        rv.reset_launch_counts()

        def render():
            return rasterization(means, quats, scales, opac, colors, vm, Ks,
                                 WIDTH, HEIGHT, sh_degree=3, tile_size=ts,
                                 isect_capacity=cfg.cap, cutoff_mode=cutoff,
                                 device=dev)

        img, alpha, meta = render()
        torch.cuda.synchronize()
        launches_per_render = dict(rv.LAUNCHES)
        if min(launches_per_render.values()) < 1:
            raise AssertionError(f"a kernel did not launch: "
                                 f"{launches_per_render}")
        if int(meta["n_isects"]) != int(st.b.n_isects) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError("scene_1m render disagrees with its stages")
        render_ms = cuda_ms(render, 3)
        # the render's plain PyTorch stages, beside the kernels below
        radii_1m, m2d_1m, dep_1m = prep_1m[0], prep_1m[1], prep_1m[2]
        stage_ms = dict(
            project_and_shade=cuda_ms(lambda: project_and_shade(
                means, quats, scales, opac, colors, vm, Ks, WIDTH, HEIGHT,
                sh_degree=3), 3),
            compact=cuda_ms(lambda: rv._compact(cfg, m2d_1m, radii_1m,
                                                dep_1m), 3),
            tile_sort=cuda_ms(lambda: torch.sort(st.b.tile, stable=True), 3),
        )

        n_isects = int(st.b.n_isects)
        pc = st.pair_counts
        L, n = cfg.cap, cfg.d_s
        M = cfg.C * cfg.n
        k = {}
        k["pack_rows"] = dict(
            ms=cuda_ms(lambda: rv.pack_rows(st.row_list, n, st.b.perm), 10),
            plain_ms=cuda_ms(
                lambda: rv._pack_rows_plain(st.row_list, n, st.b.perm), 3),
            library_ms=cuda_ms(
                lambda: torch.index_select(st.b.rows, 1, st.b.perm), 10),
            bytes=(4 * n + 8 + 4 * n) * L, ops=0,
            table_ms=cuda_ms(
                lambda: rv.pack_rows(st.attr_rows, cfg.n_attr, st.b.order),
                10),
            table_library_ms=cuda_ms(
                lambda: torch.stack(st.attr_rows)[:, st.b.order], 10),
        )
        k["expand"] = dict(
            ms=cuda_ms(lambda: rv.expand(st.b.cum, st.b.base, st.b.nx,
                                         st.b.table, st.b.n_isects, cfg), 10),
            plain_ms=cuda_ms(lambda: rv._expand_plain(
                st.b.cum, st.b.base, st.b.nx, st.b.table, st.b.n_isects,
                cfg), 3),
            library_ms=None,
            bytes=(3 * 4 + 4 * cfg.n_attr) * M + 4 * L
            + 4 * (cfg.n_attr + 1) * L,
            ops=0,
        )
        k["raster_fwd"] = dict(
            ms=cuda_ms(lambda: rv.raster_fwd(st.b.S, st.b.starts, st.masks,
                                             cfg), 10),
            plain_ms=cuda_ms(lambda: rv._fwd_plain(
                st.b.S, st.b.starts, st.masks, cfg), 1),
            library_ms=None,
            bytes=4 * (6 + cfg.channels) * n_isects
            + 4 * (cfg.n_tiles_v + 1) + 4 * cfg.n_tiles
            + 4 * cfg.n_tiles * cfg.pixels * (cfg.channels + 1),
            ops=FWD_OPS_EVALUATED * pc["evaluated"]
            + FWD_OPS_TESTED[cutoff] * pc["tested"]
            + (1 + 2 * cfg.channels) * pc["composited"],
            pair_counts=pc,
        )
        for name, d in k.items():
            t_bytes = d["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = d["ops"] / F32_OPS_PER_S * 1e3
            d["bound_ms"] = max(t_bytes, t_ops)
            d["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rows_1m.append(dict(tile_size=ts, cutoff=cutoff, n_isects=n_isects,
                            rows_in_tiles=int(st.b.starts[cfg.n_tiles]
                                              - st.b.starts[0]),
                            isect_capacity=cfg.cap, render_ms=render_ms,
                            stage_ms=stage_ms,
                            launches_per_render=launches_per_render,
                            kernels=k, check=check,
                            mean_alpha=float(alpha.mean())))
        if (ts, cutoff) == (16, "exact"):
            perf = k
        del st
    emit({"phase": "scene_1m", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "binned_rows_tile16": binned_rows, "runs": rows_1m,
          "seconds": time.perf_counter() - t0})

    emit({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"],
             launches=serve_launches[name], max_abs_err=errs[name],
             ms=perf[name]["ms"], plain_ms=perf[name]["plain_ms"],
             bound_ms=perf[name]["bound_ms"],
             bound_by=perf[name]["bound_by"],
             library_ms=perf[name]["library_ms"])
        for name in KERNELS
    ], "total_seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
