#!/usr/bin/env python3
"""Smoke run of gscodec_studio_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one JSON line each with its own ``seconds``:
  device    nvidia-smi's name and power limit, torch and CUDA versions;
  build     the nvcc build of csrc/*.cu (route: plain-C .so + ctypes);
  kernels   each kernel against its plain PyTorch version on the card: a
            20k-Gaussian scene at 320x240, tile 16 and 32, both cutoffs,
            the backward with absgrad off and on, and each backward kernel
            run twice for the same bits;
  serve     the committed checkpoint results/garden_ab_f32/splats_final.npz
            (120k Gaussians, SH 3) rendered from 8 orbit cameras at
            1297x840 through utils.ply_render.render_splats, and its first
            view's kernels held against their plain versions;
  scene_1m  the 1M-Gaussian SH-3 synthetic scene at 1297x840: tile 16 and
            32 with the exact cutoff, tile 16 with the soft one; render
            time, per-kernel time, plain time, library time and the bound
            of each kernel, with each kernel held against its plain version;
  train_1m  the same scene, tile 16, both cutoffs: forward + backward of
            rendering.rasterization with a seeded cotangent (median ms,
            Mpix/s, launches), and the backward kernels' time, bound, plain
            and library times and errors at its shapes;
  train     training.trainer.Runner with the default Config on the stand-in
            of utils.scenes.checkpoint_stand_in (the checkpoint rendered
            from 8 views at 1297x840, 7 to train, 1 held out), 30 steps with
            refines at steps 10, 20 and 30 and SH degree 3 from step 15: loss,
            held-out PSNR before and after, step ms, live counts, launches;
            then B2's time on each training view at the run's final
            splats, SH degree and capacity, and the slowest view's kernels,
            forward and backward, held against their plain versions.
Then a line {"kernels": [...]} with each kernel's numbers (launches from
the train phase, the slice's main path), the card's name and power limit,
and the result line. Any failed check raises, and the script exits
non-zero without the result line.
"""

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "results" / "garden_ab_f32" / "splats_final.npz"
WIDTH, HEIGHT = 1297, 840
N_1M = 1_000_000
N_SMALL = 20_000
TRAIN_STEPS = 30
FWD_TOL = 1e-4  # kernel vs plain forward, max abs on colors and alpha
BWD_TOL = 1e-4  # kernel vs plain backward, relative to each row's max |.|
SEGSUM_TOL = 1e-5  # kernel vs plain segment sums, relative to max |sum|
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
# raster_bwd, from csrc/raster_bwd.cu: the forward's walk again (the same
# evaluated and tested pairs), and for each composited (pair, pixel) the
# weight, G (2*CH), the suffix term (2), 1/(1-alpha), v_alpha (5), v_sig
# (2), the five geometry products (16), CH colour products, and one add
# per gradient row for the sum over the tile's pixels (d_g).
BWD_OPS_COMPOSITED = 27  # + 3*CH + d_g (+ 2 with absgrad)

KERNELS = {
    "pack_rows": dict(source="gscodec_studio_tpu_torch/csrc/pack.cu",
                      replaces="gscodec_studio_tpu/ops/raster_v2.py:324"),
    "expand": dict(source="gscodec_studio_tpu_torch/csrc/expand.cu",
                   replaces="gscodec_studio_tpu/ops/raster_v2.py:424"),
    "raster_fwd": dict(source="gscodec_studio_tpu_torch/csrc/raster_fwd.cu",
                       replaces="gscodec_studio_tpu/ops/raster_v2.py:883"),
    "raster_bwd": dict(source="gscodec_studio_tpu_torch/csrc/raster_bwd.cu",
                       replaces="gscodec_studio_tpu/ops/raster_v2.py:1025"),
    "segsum_rows": dict(source="gscodec_studio_tpu_torch/csrc/segsum.cu",
                        replaces="gscodec_studio_tpu/ops/raster_v2.py:1361"),
    "unpack_rows": dict(source="gscodec_studio_tpu_torch/csrc/unpack.cu",
                        replaces="gscodec_studio_tpu/ops/raster_v2.py:354"),
}


FWD_KERNELS = ("pack_rows", "expand", "raster_fwd")  # a render's kernels


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


def median_ms(fn, reps):
    """Median device time of one ``fn`` call over ``reps`` calls after one
    warm-up, each between its own pair of CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), times


def bound(d):
    """Adds bound_ms and bound_by to a kernel's dict of bytes and ops."""
    t_bytes = d["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = d["ops"] / F32_OPS_PER_S * 1e3
    d["bound_ms"] = max(t_bytes, t_ops)
    d["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return d


def device_profile(fn, reps=3):
    """torch.profiler over ``reps`` calls of ``fn``: the device time by
    kernel (top 12), their sum, the window's wall time and the device's
    busy share (sum of kernel time over wall time: the kernels run on one
    stream). Only device events count; the host-side operators that
    launched them would count the same time twice. If the profiler itself
    fails to start, stop or be read, records its error instead; an error
    raised by ``fn`` propagates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # the trace is a diagnostic, not a check
        return {"error": repr(e)}
    stop_error = None
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        try:
            prof.stop()
        except Exception as e:
            stop_error = {"error": repr(e)}
    if stop_error is not None:
        return stop_error
    try:
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
                rows.append((ev.key, dev_us / 1e3 / reps, ev.count // reps))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        return {"wall_ms_per_call": wall_ms / reps,
                "device_ms_per_call": busy,
                "device_busy_share": busy / (wall_ms / reps) if rows
                else None,
                "top": [{"name": n[:80], "ms": m, "calls": c}
                        for n, m, c in rows[:12]]}
    except Exception as e:  # the trace is a diagnostic, not a check
        return {"error": repr(e)}


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

    def cotangent(self, seed):
        """A seeded standard-normal cotangent of the tile outputs."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        self.v_tiles = torch.randn(self.out.shape, generator=g).to(
            self.out.device)

    def compare_bwd(self, errs, seed=0):
        """The backward kernels against their plain versions on a seeded
        cotangent of the tile outputs: raster_bwd with absgrad off and on
        (BWD_TOL of each row's largest |value|), unpack_rows bit for bit,
        segsum_rows within SEGSUM_TOL of the largest |sum|; each kernel run
        twice gives the same bits. ``errs`` takes the largest absolute
        errors, the result both kinds. Keeps the absgrad-off inputs for
        timing."""
        rv, cfg, b = self.rv, self.cfg, self.b
        self.cotangent(seed)
        res = {}
        for absgrad in (False, True):
            args = (b.S, b.starts, self.masks, self.out, self.v_tiles, cfg,
                    absgrad)
            gbuf = rv.raster_bwd(*args)
            ref = rv._bwd_plain(*args)
            diff = (gbuf - ref).abs()
            scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
            err = float((diff / scale).max())
            if not (math.isfinite(err) and err <= BWD_TOL):
                raise AssertionError(f"raster_bwd rel err {err} > {BWD_TOL}")
            if not torch.equal(gbuf, rv.raster_bwd(*args)):
                raise AssertionError("raster_bwd differs between two runs")
            abs_err = float(diff.max())
            errs["raster_bwd"] = max(errs.get("raster_bwd", 0.0), abs_err)
            res[f"bwd_rel_err_absgrad_{int(absgrad)}"] = err
            res[f"bwd_max_abs_err_absgrad_{int(absgrad)}"] = abs_err
            if not absgrad:
                self.gbuf = gbuf
        d_g = self.gbuf.shape[0]
        rows = rv.unpack_rows(self.gbuf, d_g, b.perm)
        if not (torch.equal(rows, rv._unpack_rows_plain(self.gbuf, d_g,
                                                        b.perm))
                and torch.equal(rows, rv.unpack_rows(self.gbuf, d_g,
                                                     b.perm))):
            raise AssertionError("unpack_rows differs from its plain version "
                                 "or between two runs")
        errs["unpack_rows"] = max(errs.get("unpack_rows", 0.0), 0.0)
        self.rows = rows
        seg = rv.segsum_rows(rows, b.cum, b.n_isects)
        ref = rv._segsum_plain(rows, b.cum, b.n_isects)
        abs_err = float((seg - ref).abs().max())
        err = abs_err / max(float(ref.abs().max()), 1e-30)
        if not (math.isfinite(err) and err <= SEGSUM_TOL):
            raise AssertionError(f"segsum_rows rel err {err} > {SEGSUM_TOL}")
        if not torch.equal(seg, rv.segsum_rows(rows, b.cum, b.n_isects)):
            raise AssertionError("segsum_rows differs between two runs")
        errs["segsum_rows"] = max(errs.get("segsum_rows", 0.0), abs_err)
        res["segsum_rel_err"] = err
        res["segsum_max_abs_err"] = abs_err
        self.seg = seg
        return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gscodec_studio_tpu_torch import native
    from gscodec_studio_tpu_torch.models.splats import (from_jax_splats,
                                                        splat_activations)
    from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.rendering import (project_and_shade,
                                                    rasterization)
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner
    from gscodec_studio_tpu_torch.utils.ply_render import (orbit_cameras,
                                                           render_splats)
    from gscodec_studio_tpu_torch.utils.scenes import (checkpoint_stand_in,
                                                       make_scene)

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

    def check_training_views(runner, sh_degree, errs):
        """The kernels on the training run's own inputs: each training
        view at the run's splats, SH degree and intersection capacity. Times
        B2 on every view with a seeded cotangent, then holds the slowest
        view's kernels, forward and backward, against their plain
        versions."""
        tc = runner.cfg
        sp = runner.splats
        data = runner._device_trainset()
        H, W = data["image"].shape[1:3]
        with torch.no_grad():
            means, quats, scales, opac = splat_activations(sp)
            colors = torch.cat([sp["sh0"], sp["shN"]], 1)

        def view_stages(i):
            prep = project_and_shade(
                means, quats, scales, opac, colors,
                torch.linalg.inv(data["camtoworld"][i:i + 1]),
                data["K"][i:i + 1], W, H, near_plane=tc.near_plane,
                far_plane=tc.far_plane, sh_degree=sh_degree,
                antialiased=tc.antialiased)
            return stages_for(prep, W, H, tc.tile_size, tc.cutoff_mode,
                              cap=runner.isect_capacity())

        bwd_ms = []
        with torch.no_grad():
            for i in range(data["image"].shape[0]):
                st = view_stages(i)
                st.cotangent(seed=100 + i)
                bwd_ms.append(cuda_ms(lambda: st.rv.raster_bwd(
                    st.b.S, st.b.starts, st.masks, st.out, st.v_tiles,
                    st.cfg, False), 2))
                del st
            view = int(np.argmax(bwd_ms))
            st = view_stages(view)
            res = st.compare(errs)
            res.update(st.compare_bwd(errs, seed=100 + view))
        return dict(view=view, sh_degree=sh_degree, raster_bwd_ms=bwd_ms,
                    n_isects=int(st.b.n_isects), isect_capacity=st.cfg.cap,
                    cutoff=st.cfg.cutoff, **res)

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
            res.update(st.compare_bwd(errs, seed=ts))
            cases.append(dict(tile_size=ts, cutoff=cutoff,
                              n_isects=int(st.b.n_isects), **res))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "max_abs_err": errs,
          "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL, "segsum_tol": SEGSUM_TOL,
          "seconds": time.perf_counter() - t0})

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
    if min(serve_launches[k] for k in FWD_KERNELS) < 1:
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
        if min(launches_per_render[k] for k in FWD_KERNELS) < 1:
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
        for d in k.values():
            bound(d)
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

    # 6. train_1m: forward + backward at 1M, and the backward kernels
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(7)
    ct_img = torch.randn((1, HEIGHT, WIDTH, 3), generator=g).to(dev)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (means, quats, scales, opac, colors)]
    runs_bwd = []
    for cutoff in ("exact", "soft"):
        st = stages_for(prep_1m, WIDTH, HEIGHT, 16, cutoff)
        cfg = st.cfg
        fwd_check = st.compare(errs)
        bwd_check = st.compare_bwd(errs, seed=16)

        def forward():
            return rasterization(*leaves, vm, Ks, WIDTH, HEIGHT, sh_degree=3,
                                 tile_size=16, isect_capacity=cfg.cap,
                                 cutoff_mode=cutoff, device=dev)[0]

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            torch.autograd.backward(forward(), ct_img)

        rv.reset_launch_counts()
        fwd_bwd()
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel did not launch in fwd+bwd: "
                                 f"{launches}")
        if not all(bool(torch.isfinite(t.grad).all()) for t in leaves):
            raise AssertionError("train_1m gradients are not finite")
        fb_ms, fb_samples = median_ms(fwd_bwd, 5)
        with torch.no_grad():
            f_ms, _ = median_ms(forward, 5)
        profile = device_profile(fwd_bwd)

        CH, P, L = cfg.channels, cfg.pixels, cfg.cap
        M = cfg.C * cfg.n
        d_g = cfg.d_g(False)
        n_isects = int(st.b.n_isects)
        n_rows = int(st.b.starts[cfg.n_tiles] - st.b.starts[0])
        pc = st.pair_counts
        bwd_args = (st.b.S, st.b.starts, st.masks, st.out, st.v_tiles, cfg,
                    False)
        ids = rv.segment_ids(st.b.cum, st.b.n_isects)
        rows_n = st.rows[:, :n_isects]
        k = {}
        k["raster_bwd"] = bound(dict(
            ms=cuda_ms(lambda: rv.raster_bwd(*bwd_args), 10),
            plain_ms=cuda_ms(lambda: rv._bwd_plain(*bwd_args), 1),
            library_ms=None,
            bytes=4 * (6 + CH) * n_rows + 4 * (cfg.n_tiles_v + 1)
            + 4 * cfg.n_tiles + 2 * 4 * cfg.n_tiles * P * (CH + 1)
            + 4 * d_g * L,
            ops=FWD_OPS_EVALUATED * pc["evaluated"]
            + FWD_OPS_TESTED[cutoff] * pc["tested"]
            + (BWD_OPS_COMPOSITED + 3 * CH + d_g) * pc["composited"],
            pair_counts=pc))
        k["segsum_rows"] = bound(dict(
            ms=cuda_ms(lambda: rv.segsum_rows(st.rows, st.b.cum,
                                              st.b.n_isects), 10),
            plain_ms=cuda_ms(lambda: rv._segsum_plain(st.rows, st.b.cum,
                                                      st.b.n_isects), 3),
            library_ms=cuda_ms(lambda: torch.zeros(
                (d_g, M), device=dev).index_add_(1, ids, rows_n), 10),
            bytes=4 * d_g * n_isects + 4 * M + 4 * d_g * M,
            ops=d_g * n_isects))
        k["unpack_rows"] = bound(dict(
            ms=cuda_ms(lambda: rv.unpack_rows(st.gbuf, d_g, st.b.perm), 10),
            plain_ms=cuda_ms(lambda: rv._unpack_rows_plain(
                st.gbuf, d_g, st.b.perm), 10),
            library_ms=cuda_ms(lambda: torch.empty_like(st.gbuf).index_copy_(
                1, st.b.perm, st.gbuf), 10),
            bytes=(4 * d_g + 8 + 4 * d_g) * L, ops=0,
            per_gaussian_ms=cuda_ms(lambda: rv.unpack_rows(
                st.seg, d_g, st.b.order), 10),
            per_gaussian_library_ms=cuda_ms(
                lambda: torch.empty_like(st.seg).index_copy_(
                    1, st.b.order, st.seg), 10)))
        runs_bwd.append(dict(
            tile_size=16, cutoff=cutoff, n_isects=n_isects,
            rows_in_tiles=n_rows, isect_capacity=L, fwd_bwd_ms=fb_ms,
            fwd_bwd_ms_samples=fb_samples, fwd_ms=f_ms,
            mpix_per_s=WIDTH * HEIGHT / (fb_ms * 1e-3) / 1e6,
            launches_per_fwd_bwd=launches, kernels=k, profile=profile,
            check=dict(fwd_check, **bwd_check)))
        if cutoff == "exact":
            perf.update(k)
        del st
    emit({"phase": "train_1m", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "runs": runs_bwd,
          "seconds": time.perf_counter() - t0})

    # 7. train: the port's Runner on the checkpoint stand-in
    t0 = time.perf_counter()
    parser, trainset, valset = checkpoint_stand_in(
        CHECKPOINT, n_views=8, width=WIDTH, height=HEIGHT, device=dev)
    data_s = time.perf_counter() - t0
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_train_")  # eval's json
    tcfg = Config(result_dir=stats_dir, refine_start_iter=5,
                  refine_every=10, sh_degree_interval=5)
    runner = Runner(tcfg, parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    cap = runner.splats["means"].shape[0]
    before = runner.eval("before")
    steps = []
    train_step = runner.train_step

    def timed_step(idx, sh_degree):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = train_step(idx, sh_degree)  # ends in a host sync
        e1.record()
        e1.synchronize()
        steps.append(dict(out, ms=e0.elapsed_time(e1), sh_degree=sh_degree))
        return out

    runner.train_step = timed_step
    t1 = time.perf_counter()
    rv.reset_launch_counts()
    losses = runner.train(max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_launches = dict(rv.LAUNCHES)
    train_s = time.perf_counter() - t1
    after = runner.eval("after")
    train_check = check_training_views(runner, steps[-1]["sh_degree"], errs)
    # one more step of each training view under the profiler, after the
    # measurements: which kernels a view's step spends its time in
    step_profiles = {}
    for view in range(len(trainset)):
        prof = device_profile(lambda: train_step([view], 3), reps=1)
        step_profiles[view] = dict(prof, top=prof.get("top", [])[:6])
    refines = [e for e in runner.events if e["event"] == "refine"]
    loss_first, loss_last = losses[:5], losses[-5:]
    if not np.mean(loss_last) < np.mean(loss_first):
        raise AssertionError(f"train loss did not fall: {losses}")
    if not after["psnr"] > before["psnr"]:
        raise AssertionError(f"held-out PSNR did not rise: {before} -> "
                             f"{after}")
    if min(train_launches.values()) < 1:
        raise AssertionError(f"a kernel did not launch in training: "
                             f"{train_launches}")
    if runner.skipped_steps or len(refines) < 2 or \
            max(s["sh_degree"] for s in steps) != 3:
        raise AssertionError(f"skipped {runner.skipped_steps}, refines "
                             f"{refines}, SH degrees "
                             f"{sorted({s['sh_degree'] for s in steps})}")
    emit({"phase": "train", "checkpoint": str(CHECKPOINT.relative_to(ROOT)),
          "views": 8, "train_views": len(trainset), "width": WIDTH,
          "height": HEIGHT, "steps": TRAIN_STEPS, "capacity": cap,
          "isect_capacity": runner.isect_capacity(),
          "cutoff_mode": tcfg.cutoff_mode, "tile_size": tcfg.tile_size,
          "loss_first5": loss_first, "loss_last5": loss_last,
          "psnr_before": before["psnr"], "psnr_after": after["psnr"],
          "ssim_before": before["ssim"], "ssim_after": after["ssim"],
          "step_ms_median": float(np.median([s["ms"] for s in steps])),
          "step_ms": [s["ms"] for s in steps],
          "n_isects": [s["n_isects"] for s in steps],
          "events": runner.events, "skipped_steps": runner.skipped_steps,
          "launches": train_launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in train_launches.items()},
          "view_order": runner.view_order, "view_check": train_check,
          "step_profiles": step_profiles,
          "stand_in_seconds": data_s, "train_seconds": train_s,
          "seconds": time.perf_counter() - t0})
    del runner, parser, trainset, valset
    shutil.rmtree(stats_dir, ignore_errors=True)

    emit({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"],
             launches=train_launches[name], max_abs_err=errs[name],
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
