#!/usr/bin/env python3
"""Smoke run of gscodec_studio_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one JSON line each with its own ``seconds``:
  device    nvidia-smi's name and power limit, torch and CUDA versions;
  build     the nvcc build of csrc/*.cu (route: plain-C .so + ctypes), with
            the registers and spills of every kernel entry (ptxas), and
            B1's, B2's, B5's, B6's, B7's, B8's and B9a's instantiations by
            their template arguments;
  kernels   each kernel against its plain PyTorch version on the card: a
            20k-Gaussian scene at 320x240, tile 16 and 32, both cutoffs,
            the backward with absgrad off and on, and each backward kernel
            run twice for the same bits (the forwards too); B1 and B2 at 40
            channels (B1 also at tile 32, its 1024-thread build); the
            sorted table's precision branches on the same scene, tile 16
            and 32, both cutoffs: attr_dtype "bf16", geom_dtype "u16",
            log_composite, and all three (each case's backward also with
            packed gradient rows); the same scene as surfels (tile 16, both
            cutoffs) for the 2DGS tile kernels B5 and B6, in the product
            and the log branch, and the expansion's no-cull branch, with
            B6's work from the plain walk (b6_work: per tile the rows
            walked, the pairs and (pair, pixel) slots composited, as max,
            p99 and mean; the slots inside B6's candidate regions, checked
            to hold every slot that passes the alpha test; the (pair, warp)
            with a candidate, the hits and the single-lane ones, in B6's
            warp layout); B2's candidate regions on each 3DGS case
            (b2_regions: raster_v2._bwd_counts in B2's layout, checked to
            hold every slot that passes the alpha test), and B1's and B5's
            (b1_work, b5_work: b6_work for the forwards, in their layouts,
            raster_v2._fwd_counts and raster_v2_2dgs._fwd_2dgs_counts);
  serve     the committed checkpoint results/garden_ab_f32/splats_final.npz
            (120k Gaussians, SH 3) rendered from 8 orbit cameras at
            1297x840 through utils.ply_render.render_splats, and its first
            view's kernels held against their plain versions;
  scene_1m  the 1M-Gaussian SH-3 synthetic scene at 1297x840: tile 16 and
            32 with the exact cutoff, tile 16 with the soft one; render
            time, per-kernel time, plain time, library time and the bound
            of each kernel, with each kernel held against its plain version;
            B1's and B2's time at each tile size (16 beside 32, and their
            ratio) and their regions; B1 in index order (a render with no
            backward) beside the training path's longest-run-first order,
            and the argsort that makes it;
  train_1m  the same scene, tile 16, both cutoffs: forward + backward of
            rendering.rasterization with a seeded cotangent (median ms,
            Mpix/s, launches), and the backward kernels' time, bound, plain
            and library times and errors at its shapes (B9b's second
            launch, through the depth order, under per_gaussian, and its
            first at 1, 2, 3 and 9 rows through perm beside an identity
            permutation, row_sweep); B4's work (b4_work:
            raster_v2.segsum_counts, the range lengths, the first design's
            longest warp walk and the merge-path blocks'); B2's work (b2_work:
            as b6_work, in B2's layout, with the (pair, warp) that the
            expansion's disc would leave beside B2's box, the build's
            registers and spills, B2 on the longest tile alone), and
            b1_work for B1; B3's (b3_work: raster_v2.expand_counts in its
            block layout, the rows in range and past n_isects, each block's
            window of Gaussians, the longest run, the culled pairs, with
            B3's time and bound); B1 and B2 at 40 channels (B1 against its
            plain version there, within FWD_TOL but at the pixels where the two
            round to either side of the exact cutoff, cutoff_flips, with
            its bound);
  train_1m_2dgs  the same scene's surfels through
            rendering.rasterization_2dgs, tile 16, exact cutoff: forward and
            forward + backward with a seeded cotangent on the colours,
            alphas, normals and distortion (median ms, Mpix/s, launches),
            and B5's and B6's time, bound, plain time and error, B6's work
            (b6_work, with the build's registers and spills of its
            instantiation and B6's time on the longest tile alone), B5's
            (b5_work), B5's time at tile 32 and in the longest-run-first
            tile order beside index order, and
            B9a on the surfels' two gathers beside index_select and
            torch.stack(rows)[:, order]; the same with log_composite
            (B5/B6's log branch, without b6_work); and one fwd+bwd of
            rasterize_to_pixels_2dgs_v2 with an absgrad probe (B6's absgrad
            rows: launches, the probe's gradient, the rows against their
            plain version and twice for the same bits, time and bound);
            B4 and B9b on the surfels' 19 gradient rows (segsum_rows_2dgs,
            unpack_rows_2dgs with its row sweep up to 19 rows, b4_work),
            and b3_work for B3's no-cull branch;
  bench_1m  bench.py's default configuration through the port: the same
            scene, tile 32, soft cutoff, grad_dtype "bf16", attr_dtype
            "bf16", log_composite, capacity 1.2x the probed elliptical rows,
            the loss mean((img - 0.5)^2) + 0.1 mean(alpha) backward to the
            means: fwd+bwd median ms and Mpix/s, beside the same call with
            every knob at f32/off and with geom_dtype "u16" (and the count
            of binned centres outside [-4096, 4096) px); each new branch's
            kernel time, launches, bound and plain time beside the f32
            branch's, every kernel held against its plain version on these
            inputs; b2_work, b1_work and b3_work on bench.py's
            configuration;
  train     training.trainer.Runner with the default Config on the stand-in
            of utils.scenes.checkpoint_stand_in (the checkpoint rendered
            from 8 views at 1297x840, 7 to train, 1 held out), 30 steps with
            refines at steps 10, 20 and 30 and SH degree 3 from step 15: loss,
            held-out PSNR before and after, step ms, live counts, launches;
            then B2's time on each training view at the run's final
            splats, SH degree and capacity, and the slowest view's kernels,
            forward and backward, held against their plain versions, with
            B1's and B2's regions checked there (also in train_ladder and
            train_packed), and b3_work there;
  train_2dgs  training.trainer_2dgs.Runner2DGS with the default Config2DGS
            on the same stand-in, 30 steps with the train phase's refine
            and SH settings and the normal and distortion losses from step
            6 (the loss must fall from steps 6-10 to the last 5): loss,
            held-out PSNR, step ms, launches; then B6 timed on each
            training view and the slowest view's 2DGS kernels held against
            their plain versions, with B5's and B6's regions checked
            there and B4's work (b4_work);
  train_ladder  the garden ladder's recipe (examples/garden_benchmark.py,
            results/garden_ladder_r5/stats.json) through Runner on the same
            stand-in: MCMC at a capacity of 120,000, the compression
            simulation with the entropy models and the shN mask, opacity
            and scale regularisers, grad_dtype "bf16" (the packed-pair
            branches of the tile backward and the segment sums), 30 steps,
            the entropy and mask gates moved to step 5: loss, held-out
            PSNR, step ms, the allocated count after each refine, the bits
            term, per-view profiled steps; then the packed kernels on the
            slowest view's own inputs against their plain versions;
  train_packed  the ladder's recipe with attr_dtype "bf16" and
            log_composite (examples/garden_benchmark.py --attr_dtype bf16
            --log_composite) as train_ladder runs it: loss, held-out PSNR,
            step ms, skipped steps; then the slowest view's kernels against
            their plain versions;
  train_2dgs_mcmc  Runner2DGS at strategy "mcmc" on the same stand-in,
            20 steps: loss, skipped steps, the allocated count;
  kernels_v1  the kernels phase's scene's scalar radii (tile 16 and 32,
            both cutoffs; tile 32 also at 64 and 128 channels) through the
            legacy v1 kernels B7 and B8 against their plain versions (both
            also twice and in the longest-run-first tile order for the
            same bits), with their work from the plain walk in their layout
            (b7_work, b8_work: rasterize_pallas._region_counts, the slots
            walked, the candidate ones, checked to hold every slot that
            passes the alpha test, those tested and composited, the (pair,
            warp) walked, meeting the box, with a candidate, hit and hit by
            one lane; each kernel's build and its registers and spills);
  serve_v1  serve's 8 views through render_splats(rasterizer="pallas")
            (the v1 backend at its default soft cutoff), capacity 1.2x the
            probed scalar-radius rows; view 0's B7 against its plain
            version;
  scene_1m_v1  scene_1m's scene through rasterization(rasterizer="pallas"),
            tile 16, soft and exact, the default capacity: forward and
            fwd+bwd median ms, Mpix/s, intersections against the capacity,
            the chunks walked, one B7 and one B8 launch per fwd+bwd, B7's
            and B8's time, bound (on their candidate slots, the plain
            walk's beside it) and plain time and their check, b7_work and
            b8_work with each kernel on the longest tile alone, both in
            index order beside the longest-run-first order and its
            argsort; the "sort" reduction's per-Gaussian sums, whose running
            sums B10 takes (one launch a fwd+bwd), each held within the
            rounding bound of its two running sums of a float64 sum of its
            rows (sort_cancellation), and B10 on that [6 + CH, cap2] table
            against a float64 cumsum, twice for the same bits and timed
            beside torch.cumsum (cumsum_rows);
  train_v1  the train phase's run with Config(rasterizer="pallas"): loss,
            held-out PSNR, step ms, launches (one B7, one B8 and one B10 a
            step), a profiled step; then B8 timed on every training view
            and the slowest view's B7 and B8 against their plain versions,
            with b7_work, b8_work, the tile orders and B10 on the view's
            reduction table (cumsum_rows) there;
  cumsum_skel  B10 (cumsum_rows) at [9, 2^23], signed and non-negative,
            against a float64 torch.cumsum within the rounding bound of its
            own order of additions, timed beside torch.cumsum; B11 (the
            compositing skeleton, profiling/kernel_skel_bench.py) on the
            JAX script's four inputs (ms, us/tile, ns/isect), then against
            its plain version on those four and on one whose tiles stop
            mid-run (make_stop), twice for the same bits, with its work in
            its layout (b11_work: (pair, cell) tests and hits, candidate,
            composited and walked slots, columns, tiles stopped) and no
            composited slot outside the cells its test keeps; its bound on
            its candidate slots at term@24 (tile_bound);
  garden_recipe  the rest of examples/garden_benchmark.py's recipe on the
            train phase's stand-in: MCMC at 120,000 slots, SelectiveAdam
            (visible_adam) and the hash-grid entropy model
            (entropy_model_type="gaussian_model"), the gates at step 5,
            RECIPE_STEPS steps with a checkpoint at the middle (loss,
            PSNR, step ms, launches: six SelectiveAdam launches a step,
            device busy share of two profiled steps, the hash-grid
            model's time alone and its share of the step); one more step
            with each group's SelectiveAdam launch held bit for bit
            against its plain version on the recipe's visibility, and
            both timed (the kernel's numbers are the step's six launches
            summed; its bound the bytes of p, g, mu, nu read, p, mu, nu
            written and the visibility); the middle checkpoint reloaded
            into a fresh Runner bit for bit, and the committed JAX
            checkpoint results/garden_ab_f32/ckpts/ckpt_750.npz loaded;
            run_compression("png") of the trained scene (its stages'
            seconds, the grid side, size_bytes, PSNR before and after the
            codec); the committed bitstream
            results/garden_ab_f32/compression_1500/ decoded and rendered
            on the held-out view;
  colmap_trainer  the stand-in written as a COLMAP directory and trained
            through simple_trainer's command line with the per-image
            modules;
  cameras   the serve checkpoint from 4 orbit views at 1297x840, tile 16,
            through each camera model: pinhole (the orbit's K), ortho (fx
            = fy = the width over the scene's extent across the view) and
            fisheye (the orbit's K): each model's intersections a view
            against the capacity and the default one, one fwd+bwd of
            rasterization(rasterizer="fused") of the four views (launches,
            ms, device profile), B9a, B3, B1, B2, B9b and B4 on the batch's
            own inputs against their plain versions with B1's and B2's
            regions, each kernel's ms beside pinhole's; one v1 forward,
            B7 and B8 against their plain versions with their regions; the
            projection and its gradients on the card against the CPU, and
            explicit covariances against quats and scales;
  entropy_codec  run_compression("entropy_coding") of the train phase's
            runner (histogram tables), the train_ladder's (factorized
            tables) and garden_recipe's after its PNG codec (Gaussian
            context tables, the same scene): the stages' seconds, the grid
            side, size_bytes and each attribute's bytes, PSNR before and
            after, gsc_metrics of the held-out view's render before and
            after, sequence_metrics of the trained and decoded splats as a
            pair of frames on the stand-in's first 4 orbit views, the
            evaluation's forward launches, the stream decoded again on the
            CPU to the card's decode bit for bit, the decoded scene's
            held-out render timed by utils/profiling.honest_timer; for the
            model tables the same splats' bytes against histograms; the
            Gaussians whose raw log scale the codec's bound clips, and the
            trained PSNR with only that clip;
  dynamic   the dynamic/STG path (examples/dyn_benchmark.py's recipe) on a
            stand-in from the serve checkpoint: 30% of its Gaussians
            moving, 10 views on an arc x 20 timestamps at 648x420 rendered
            by the fused forward, views 0 and 5 held out; DynRunner under
            ModifiedSTG at 120,000 slots with the Sandwich decoder (9
            feature channels: B1 and B2 in their chm-16 builds) and the
            STG compression simulation, 200 steps (cut from 4,000; every
            cut printed under "cuts"): step ms by CUDA events, launches a
            step, the device's busy share, held-out PSNR/SSIM before and
            after with each view's intersections against the eval
            capacity, the live count after each refine; B9a, B3, B1, B2,
            B9b and B4 on the slowest trained view against their plain
            versions with B1's and B2's regions (missed_slots 0), B1 and
            B2 timed there beside the view's first 3 channels; the stg
            leg (the omega freeze at step 20: kept and frozen omegas), the
            mcmc leg through dyn_trainer_cli.main on an INVR directory,
            the v1 leg (B7, B8, B10 at 9 channels, against their plain
            versions); the trained model's 20 frames through
            compress_ply_sequence at rp0, rp2, rp3 (bytes, backend, bits,
            sequence_metrics), STGPngCompression of the trained splats,
            and the committed sequence results/dyn_stand_in/frames at qp
            30 against its committed meta.json, field by field;
  multigpu  the Gaussian-sharded mesh path (parallel/, the Runner's mesh
            mode): distributed_render of the serve checkpoint's 8 orbit
            views at world size 1 on NCCL in this process, against the
            single-device render; then 2 ranks spawned on gloo, both on
            the one card (all their times are "gloo, 2 ranks on one card",
            no multi-GPU time): the dense exchange's render against the
            single-device one, the bucketed one at a covering cap against
            the dense and at a cap of 4,096 that overflows, the exchange's
            diagnostics, bytes and all_to_all times, rank 0's B9a, B3, B1,
            B2, B9b and B4 against their plain versions on its exchanged
            rows; the dryrun (one mesh trainer step at 100,000 Gaussians,
            256x256, MCMC with the simulation, exchange_cap 4,096); the
            mesh Runner on the checkpoint stand-in, batch 2, 10 steps with
            refines after steps 5 and 10, its first loss against the
            single-device Runner's, held-out PSNR before and after, the
            ranks' models equal bit for bit at the end.
The kernels and train_1m phases also hold the packed-pair branches (B2p,
B4p) against their plain versions, and train_1m times the bf16 case beside
the f32 one. Wherever a backward is checked (check_reduction), the
gradient reduction's three launches on its rows are held against their
plain versions, B9b bit for bit and B4 within the rounding bound of its
order of additions (raster_v2.segsum_rows_bound), and each runs twice for
the same bits. Then a line {"kernels": [...]} with each kernel's numbers
(launches from its main path: the train phase, for B5 and B6 the
train_2dgs phase, for B2p and B4p the train_ladder phase, for the precision
branches of B3, B1 and B2 one fwd+bwd of bench_1m, for B5/B6's log branch
one fwd+bwd of train_1m_2dgs's log leg, for B6's absgrad rows its probed
fwd+bwd, for B7, B8 and B10 the train_v1 phase,
for B11 the cumsum_skel phase, for SelectiveAdam the garden_recipe
phase; the dynamic phase's launches a step, absolute and relative errors
beside them on its kernels; the multigpu phase's rank-0 launches over the
mesh Runner's steps and its errors on the exchanged rows beside them, as
mesh_launches, mesh_max_abs_err and mesh_rel_err; the tile kernels' bounds, B1's,
B2's, B5's, B6's, B7's, B8's and B11's, on their candidate slots, tile_bound,
with the plain walk's beside them in the phases), the card's name and
power limit, and
the result line. Any failed check raises, and the script exits non-zero
without the result line.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import struct
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
LADDER_CAP = 120_000  # the checkpoint's slot count
LADDER_GATE = 5  # the entropy and mask gates' step in the ladder phase
RECIPE_STEPS = 20  # garden_recipe's training steps; it saves at the middle
COLMAP_STEPS = 30  # colmap_trainer's steps; it saves at the middle
COMMITTED_CKPT = ROOT / "results" / "garden_ab_f32" / "ckpts" / "ckpt_750.npz"
BITSTREAM = ROOT / "results" / "garden_ab_f32" / "compression_1500"
MCMC_2DGS_STEPS = 20
FWD_TOL = 1e-4  # kernel vs plain forward, max abs on colors and alpha
BWD_TOL = 1e-4  # kernel vs plain backward, relative to each row's max |.|
# packed pairs: each half within one bf16 step (2^-7 of its value) of the
# plain version's half, plus the f32 branch's tolerance; bf16 gradients
# within 1.5e-2 of each gradient's scale of the f32 ones (the JAX package's
# own bound, tests/test_raster_v2.py)
BF16_STEP = 2.0 ** -7
BF16_GRAD_TOL = 1.5e-2
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
# raster_fwd_2dgs, from csrc/raster_fwd_2dgs.cu: for each evaluated pair the
# cross-product pair math (h_u, h_v: 12; cz, cx, cy: 9 and the cz test;
# 1/cz, su, sv, gw3d: 6; dx, dy, gw2d: 6; sigma, exp, op*exp, min and the
# alpha test: 6); the forward's transmittance step for each tested pair;
# for each composited pair the weight, CB multiply-adds, w*z, the
# distortion term (6), A and the median test (2).
FWD2_OPS_EVALUATED = 41
FWD2_OPS_COMPOSITED = 11  # + 2*CB
# raster_bwd_2dgs, from csrc/raster_bwd_2dgs.cu: B5's walk again, and for
# each composited (pair, pixel) w, w*z, P, S, SZ (7), G (2*CB), Dw (7), GD,
# the suffix term (2), 1/(1-alpha), v_alpha (5), v_sig (2), the depth
# chain's extra (4) and A, then CB colour products and one add per
# gradient row (d_g = 12 + CB) for the sum over the tile's pixels; plus
# the branch: 39 through the cross product (UV) or 4 to means2d (filter).
BWD2_OPS_COMPOSITED = 30  # + 3*CB + d_g
BWD2_OPS_UV, BWD2_OPS_FILTER = 39, 4
# with absgrad, per composited (pair, pixel) of the filter branch: the two
# |.| terms and their adds (the rows' sums count in d_g)
BWD2_OPS_ABS = 4
# the log scan (csrc/tile_common.cuh and the tile kernels' LOG branches), in
# place of FWD_OPS_TESTED in all four tile kernels: -alpha, log1p, two bf16
# roundings, l - l1, the two running sums and their sum (8); incl - l, exp
# and T*exp for T_prev (3); exact only, T*exp(incl), its test and the min
# (4). The packed rows add no float operation to a pair: they are unpacked
# once per staged column, and cut the bytes read.
LOG_OPS_TESTED = {"exact": 15, "soft": 11}

# raster_v1_fwd, from csrc/raster_v1_fwd.cu: per candidate (pair, pixel)
# (tile_bound; the plain walk's bound on each evaluated one) dx, dy, the
# nine operations of sigma = 0.5 * (a dx dx + c dy dy)
# + b dx dy, its negation, exp, op * exp, min and two tests (17); the
# transmittance step per tested pair (FWD_OPS_TESTED); the weight and CH
# multiply-adds per composited pair (1 + 2*CH, as raster_fwd).
V1_OPS_EVALUATED = 17
# raster_v1_bwd, from csrc/raster_v1_bwd.cu: B7's walk again, and per
# composited (pair, pixel) the weight, G (2*CH), q (2), 1/(1-alpha),
# v_alpha (5), v_sig (2), the five geometry terms (16) and the opacity
# term (1), CH colour products, and one add per gradient row (6 + CH) for
# the sum over the tile's pixels.
V1_BWD_OPS_COMPOSITED = 28  # + 3*CH + 6 + CH
# skel_composite, from csrc/skel_composite.cu: per candidate (pair, pixel)
# (tile_bound: the slots of the (pair, cell)s its cell test keeps; the
# plain walk's bound on each evaluated one) dx, dy, sigma's eight
# operations (0.5 a and 0.5 c are formed once a pair as the chunk is
# staged), its negation, exp, op * exp, min and two tests (16); per
# composited pair the weight, three multiply-adds and T * (1 - alpha) (9).
SKEL_OPS_EVALUATED, SKEL_OPS_COMPOSITED = 16, 9
UNPACK_SWEEP_ROWS = (1, 2, 3, 9, 19)  # B9b's rows against the identity
UNPACK_GROUPS = (1, 2, 3, 4)  # B9b's row groups timed beside all rows
CUMSUM_SHAPE = (9, 1 << 23)  # B10's input: 9 rows as the JAX table's

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
    "raster_fwd_2dgs": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_fwd_2dgs.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2_2dgs.py:137"),
    "raster_bwd_2dgs": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd_2dgs.cuh",
        replaces="gscodec_studio_tpu/ops/raster_v2_2dgs.py:265"),
    "raster_bwd_packed": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:998"),
    "segsum_rows_packed": dict(
        source="gscodec_studio_tpu_torch/csrc/segsum.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:1412"),
    "expand_packed": dict(
        source="gscodec_studio_tpu_torch/csrc/expand.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:520"),
    "raster_fwd_unpack": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_fwd.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:782"),
    "raster_fwd_log": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_fwd.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:931"),
    "raster_bwd_unpack": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:766"),
    "raster_bwd_log": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:1131"),
    "raster_fwd_2dgs_log": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_fwd_2dgs.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2_2dgs.py:184"),
    "raster_bwd_2dgs_log": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd_2dgs.cuh",
        replaces="gscodec_studio_tpu/ops/raster_v2_2dgs.py:353"),
    "raster_bwd_2dgs_absgrad": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_bwd_2dgs_absgrad.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2_2dgs.py:453"),
    "raster_v1_fwd": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_v1_fwd.cu",
        replaces="gscodec_studio_tpu/ops/rasterize_pallas.py:214"),
    "raster_v1_bwd": dict(
        source="gscodec_studio_tpu_torch/csrc/raster_v1_bwd.cu",
        replaces="gscodec_studio_tpu/ops/rasterize_pallas.py:281"),
    "cumsum_rows": dict(
        source="gscodec_studio_tpu_torch/csrc/cumsum_rows.cu",
        replaces="gscodec_studio_tpu/ops/raster_v2.py:1505"),
    "skel_composite": dict(
        source="gscodec_studio_tpu_torch/csrc/skel_composite.cu",
        replaces="profiling/kernel_skel_bench.py:65"),
    # no Pallas counterpart: the JAX package's SelectiveAdam step is plain
    # jnp, which XLA fuses into one pass
    "selective_adam": dict(
        source="gscodec_studio_tpu_torch/csrc/selective_adam.cu",
        replaces="gscodec_studio_tpu/optimizers/selective_adam.py:59"),
}
KERNELS_V1 = ("raster_v1_fwd", "raster_v1_bwd")  # rasterizer="pallas"
KERNELS_3DGS = ("pack_rows", "expand", "raster_fwd", "raster_bwd",
                "segsum_rows", "unpack_rows")  # the 3DGS training step's
KERNELS_2DGS = ("pack_rows", "expand", "raster_fwd_2dgs", "raster_bwd_2dgs",
                "segsum_rows", "unpack_rows")  # the 2DGS training step's
KERNELS_LADDER = ("pack_rows", "expand", "raster_fwd", "raster_bwd_packed",
                  "segsum_rows_packed", "unpack_rows")  # grad_dtype "bf16"
# bench.py's configuration (and train_packed's): bf16 attribute pairs, the
# log scan and packed gradient rows; the f32 branches must not launch
KERNELS_BENCH = ("pack_rows", "expand_packed", "raster_fwd_unpack",
                 "raster_fwd_log", "raster_bwd_packed", "raster_bwd_unpack",
                 "raster_bwd_log", "segsum_rows_packed", "unpack_rows")
F32_BRANCHES = ("expand", "raster_fwd", "raster_bwd", "segsum_rows")
# the sorted table's precision cases of the kernels phase
PRECISION_CASES = {
    "attr_bf16": dict(attr_dtype="bf16"),
    "geom_u16": dict(geom_dtype="u16"),
    "log": dict(log_composite=True),
    "all": dict(attr_dtype="bf16", geom_dtype="u16", log_composite=True),
}


FWD_KERNELS = ("pack_rows", "expand", "raster_fwd")  # a render's kernels


def emit(obj):
    print(json.dumps(obj), flush=True)


def note_err(errs, keys, err):
    for key in keys:
        errs[key] = max(errs.get(key, 0.0), err)


def tested_ops(cfg):
    """Float operations per tested (pair, pixel) of the transmittance
    step, in the scan that cfg selects."""
    return (LOG_OPS_TESTED if cfg.log_composite else
            FWD_OPS_TESTED)[cfg.cutoff]


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


def queued_ms(fn, reps):
    """Device time of one ``fn`` call: CUDA events around ``reps`` calls
    queued behind a sleeping kernel, so that the host has enqueued them all
    before the first one runs and they run back to back (for launches
    shorter than their wrapper's host time, which cuda_ms would read)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25-30 ms of cycles
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def once_ms(fn):
    """Device time of one ``fn`` call, with no warm-up (for the plain
    versions at the 1M shapes, whose first call the checks have made)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


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


def tile_bound(d, pc, candidates, eval_ops, rest_ops):
    """bound() of a tile kernel (B1, B2, B5, B6) on the work its function
    needs on these inputs: ``eval_ops`` (the pair math up to the alpha
    test) on each candidate slot, the (pair, pixel) slots inside the pairs'
    candidate regions, which hold every slot that passes the alpha test
    (b1_regions, b2_regions, b5_regions, b6_regions), and ``rest_ops`` for
    the tested and composited slots of the plain walk (``pc``). Beside it
    walk_bound_ms: the same with ``eval_ops`` on every slot the plain walk
    evaluates."""
    d["candidate_slots"] = candidates
    d["ops"] = eval_ops * candidates + rest_ops
    d["walk_bound_ms"] = bound(dict(
        bytes=d["bytes"], ops=eval_ops * pc["evaluated"] + rest_ops))[
        "bound_ms"]
    return bound(d)


def cutoff_flips(out, ref, cmax, rv):
    """Where a 3DGS tile output (``out``, exact cutoff) differs from its
    plain version's (``ref``) by more than FWD_TOL in any channel. The two
    round each pixel's transmittance in their own orders, and where a
    pair's inclusive T lies within that rounding of the cutoff (1e-4) one
    composites the pair and the other does not. Past it the two take
    different pairs, so the outputs part by up to the weight that T can
    still give: at most T_j - 1e-4 <= 1e-4 / (1 - MAX_ALPHA) - 1e-4 (T_j
    the pair's exclusive T) times the largest colour ``cmax``. The one that
    composited it ends there, at T within rounding of 1e-4 (any later pair,
    alpha >= 1/255, would bring T below it). Returns the pixels over
    FWD_TOL, those of them that this does not explain (where neither
    version's T, read from its alpha, lies within four f32 steps near 1 of
    the cutoff, or where the error exceeds that weight), and the largest
    error."""
    d = (out - ref).abs().amax(-1)
    t_min = torch.minimum(1.0 - out[..., -1], 1.0 - ref[..., -1])
    eps = rv.TRANSMITTANCE_EPS
    at_cut = t_min <= eps + 4 * 2.0 ** -24
    most = max(cmax, 1.0) * (eps / (1.0 - rv.MAX_ALPHA) - eps)
    over = d > FWD_TOL
    return dict(pixels_over_tol=int(over.sum()),
                unexplained=int((over & ~(at_cut & (d <= most))).sum()),
                max_abs_err=float(d.max()), pixels=d.numel())


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


def ptxas_entries(text):
    """Each kernel entry of the build's -Xptxas -v report: its mangled
    name, registers, stack frame and spill bytes."""
    entries, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = dict(name=m.group(1))
            entries.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return entries


def b6_instances(entries):
    """B6's instantiations in the ptxas report: the channel bound, pixels a
    thread, cutoff, scan, absgrad rows, launch bounds (most threads, blocks
    an SM) of each, with its registers and spills."""
    out = []
    for e in entries:
        m = re.search(r"raster_bwd_2dgs_kernelILi(\d+)ELi(\d+)ELb([01])"
                      r"ELb([01])ELb([01])ELi(\d+)ELi(\d+)E", e["name"])
        if m:
            out.append(dict(cbm=int(m.group(1)), ppt=int(m.group(2)),
                            soft=m.group(3) == "1", log=m.group(4) == "1",
                            absgrad=m.group(5) == "1",
                            max_threads=int(m.group(6)),
                            min_blocks=int(m.group(7)),
                            **{k: e.get(k) for k in (
                                "registers", "spill_stores", "spill_loads",
                                "stack")}))
    return out


def tile_instances(entries, kernel, bound_key="chm"):
    """The instantiations of a tile kernel whose template is <channel
    bound, pixels a thread, soft, log, most threads, blocks an SM> (B1's
    raster_fwd_kernel, B2's raster_bwd_kernel, B5's
    raster_fwd_2dgs_kernel) in the ptxas report: the channel bound (under
    ``bound_key``), pixels a thread, cutoff, scan, launch bounds of each,
    with its registers and spills."""
    out = []
    for e in entries:
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELb([01])ELb([01])"
                      r"ELi(\d+)ELi(\d+)E", e["name"])
        if m:
            out.append(dict({bound_key: int(m.group(1))},
                            ppt=int(m.group(2)),
                            soft=m.group(3) == "1", log=m.group(4) == "1",
                            max_threads=int(m.group(5)),
                            min_blocks=int(m.group(6)),
                            **{k: e.get(k) for k in (
                                "registers", "spill_stores", "spill_loads",
                                "stack")}))
    return out


def v1_instances(entries, kernel):
    """The instantiations of B7's raster_v1_fwd_kernel or B8's
    raster_v1_bwd_kernel (template <channel bound, pixels a thread, soft,
    most threads, blocks an SM>) in the ptxas report, with their registers
    and spills."""
    out = []
    for e in entries:
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELb([01])ELi(\d+)ELi(\d+)E",
                      e["name"])
        if m:
            out.append(dict(chm=int(m.group(1)), ppt=int(m.group(2)),
                            soft=m.group(3) == "1",
                            max_threads=int(m.group(4)),
                            min_blocks=int(m.group(5)),
                            **{k: e.get(k) for k in (
                                "registers", "spill_stores", "spill_loads",
                                "stack")}))
    return out


def pack_instances(entries):
    """B9a's instantiations (rows gathered at once, columns a thread) in
    the ptxas report."""
    out = []
    for e in entries:
        m = re.search(r"pack_kernelILi(\d+)ELi(\d+)E", e["name"])
        if m:
            out.append(dict(rows=int(m.group(1)), cols=int(m.group(2)),
                            **{k: e.get(k) for k in (
                "registers", "spill_stores", "spill_loads", "stack")}))
    return out


def work_summary(c, build, cfg, ptxas, match, tail_ms=None):
    """A tile kernel's work from its region counts ``c`` (raster_v2's
    _region_counts or raster_v2_2dgs's _region_counts_2dgs): the per-tile
    distribution (max, p99, mean) of the rows walked, the pairs that at
    least one pixel composited and the composited (pair, pixel) slots; the
    slots walked and the candidate ones; the (pair, warp) walked, those
    whose cell meets the pair's box, those with a candidate, the hits and
    the single-lane ones (each where the counts have it); the build
    (``build``) and, with ``ptxas`` (tile_instances or b6_instances
    entries), its registers and spills, matched on the build's ``match``
    keys and the cutoff and scan; ``tail_ms`` (longest_tile_ms) the
    kernel on the tile with the longest walk alone, the floor that one
    block per tile puts under the whole launch."""
    def dist(x):
        x = x.double()
        return dict(max=int(x.max()), p99=float(torch.quantile(x, 0.99)),
                    mean=float(x.mean()))

    res = dict(build=build,
               per_tile={k: dist(c[k]) for k in ("run", "pairs", "slots")},
               composited_slots=int(c["slots"].sum()),
               **{k: c[k] for k in (
                   "evaluated_slots", "candidate_slots", "missed_slots",
                   "warps_per_tile", "pair_warp_walked", "pair_warp_cells",
                   "pair_warp_candidates", "pair_warp_hits",
                   "single_lane_hits") if k in c})
    if ptxas is not None:
        res["ptxas"] = [e for e in ptxas
                        if all(e[k] == build[k] for k in match)
                        and e["soft"] == (cfg.cutoff == "soft")
                        and e["log"] == cfg.log_composite]
    if tail_ms is not None:
        res["longest_tile"] = dict(zip(("ms", "tile", "run"), tail_ms))
    return res


def longest_tile_ms(c, masks, time_tail, launch):
    """``launch(masks1)`` timed by ``time_tail`` with only the tile of the
    longest walk in ``c`` unmasked: (ms, tile, run)."""
    longest = int(torch.argmax(c["run"]))
    masks1 = torch.zeros_like(masks)
    masks1[longest] = 1
    return (time_tail(lambda: launch(masks1), 5), longest,
            int(c["run"][longest]))


def b6_regions(r2, st):
    """B6's candidate regions on a Stages2DGS's inputs
    (r2._bwd_2dgs_counts, B6's layout): raises if a slot that passes the
    alpha test lies outside its pair's region; returns the counts (kept as
    st.b6_counts)."""
    c6 = getattr(st, "b6_counts", None)
    if c6 is not None:
        return c6
    c6 = r2._bwd_2dgs_counts(st.b.S, st.b.starts, st.masks, st.cfg)
    if c6["missed_slots"]:
        raise AssertionError(f"{c6['missed_slots']} passing (pair, pixel) "
                             f"slots outside B6's candidate regions")
    st.b6_counts = c6
    return c6


def b6_work(r2, st, ptxas=None, time_tail=None):
    """What B6 does on a Stages2DGS's inputs: work_summary of the plain
    walk in B6's layout (b6_regions) and build (r2.bwd_build), with B6 on
    the longest tile alone."""
    cfg = st.cfg
    c6 = b6_regions(r2, st)
    build = r2.bwd_build(cfg.channels, cfg.tile_size, cfg.absgrad)
    tail = None if time_tail is None else longest_tile_ms(
        c6, st.masks, time_tail, lambda m: r2.raster_bwd_2dgs(
            st.b.S, st.b.starts, m, *st.bwd_args[3:]))
    return work_summary(c6, build, cfg, ptxas, tuple(build), tail)


def b2_regions(rv, st):
    """B2's candidate regions on a Stages' inputs (rv._bwd_counts, B2's
    layout): raises if a slot that passes the alpha test lies outside its
    pair's region; returns the counts (kept as st.b2_counts)."""
    c2 = rv._bwd_counts(st.b.S, st.b.starts, st.masks, st.cfg)
    if c2["missed_slots"]:
        raise AssertionError(f"{c2['missed_slots']} passing (pair, pixel) "
                             f"slots outside B2's candidate regions")
    st.b2_counts = c2
    return c2


def b1_regions(rv, st):
    """B1's candidate regions on a Stages' inputs (rv._fwd_counts, B1's
    layout): raises if a slot that passes the alpha test lies outside its
    pair's region; returns the counts (kept as st.b1_counts). B1 and B2
    share the walk and the regions (csrc/regions.cuh), so where their
    layouts agree (the same pixels a thread) B2's counts, if b2_regions
    made them, are B1's."""
    cfg = st.cfg
    dense = rv.bwd_dense(cfg)
    c1 = getattr(st, "b1_counts", None)
    if c1 is not None:
        return c1
    c1 = getattr(st, "b2_counts", None)
    if c1 is None or rv.fwd_build(cfg.channels, cfg.tile_size, dense)[
            "ppt"] != rv.bwd_build(cfg.channels, cfg.tile_size,
                                   dense=dense)["ppt"]:
        c1 = rv._fwd_counts(st.b.S, st.b.starts, st.masks, cfg)
    if c1["missed_slots"]:
        raise AssertionError(f"{c1['missed_slots']} passing (pair, pixel) "
                             f"slots outside B1's candidate regions")
    st.b1_counts = c1
    return c1


def b5_regions(r2, st):
    """B5's candidate regions and their boxes on a Stages2DGS's inputs
    (r2._fwd_2dgs_counts, B5's layout): raises if a slot that passes the
    alpha test lies outside them; returns the counts (kept as
    st.b5_counts)."""
    c5 = getattr(st, "b5_counts", None)
    if c5 is not None:
        return c5
    c5 = r2._fwd_2dgs_counts(st.b.S, st.b.starts, st.masks, st.cfg)
    if c5["missed_slots"]:
        raise AssertionError(f"{c5['missed_slots']} passing (pair, pixel) "
                             f"slots outside B5's candidate regions")
    st.b5_counts = c5
    return c5


def region_summary(c):
    """The totals of a region count (b1_regions, b2_regions, b5_regions,
    r2._bwd_2dgs_counts)."""
    return dict(composited_slots=int(c["slots"].sum()), **{
        k: c[k] for k in ("evaluated_slots", "candidate_slots",
                          "missed_slots", "pair_warp_walked",
                          "pair_warp_cells", "pair_warp_candidates",
                          "pair_warp_hits", "single_lane_hits") if k in c})


def b2_work(rv, st, ptxas=None, time_tail=None):
    """b6_work for B2 on a Stages' inputs (after its compare_bwd): the
    counts of b2_regions in B2's layout and build (rv.bwd_build), with the
    (pair, warp) cell tests of the box, the expansion's disc and both, and
    B2 on the longest tile alone."""
    cfg = st.cfg
    c2 = b2_regions(rv, st)
    build = rv.bwd_build(cfg.channels, cfg.tile_size, dense=rv.bwd_dense(cfg))
    tail = None if time_tail is None else longest_tile_ms(
        c2, st.masks, time_tail, lambda m: rv.raster_bwd(
            st.b.S, st.b.starts, m, st.out, st.v_tiles, cfg, False))
    return work_summary(c2, build, cfg, ptxas,
                        ("chm", "ppt", "max_threads", "min_blocks"), tail)


def b1_work(rv, st, ptxas=None, time_tail=None):
    """b2_work for B1 on a Stages' inputs: the counts of b1_regions in
    B1's layout and build (rv.fwd_build), with B1 on the longest tile
    alone."""
    cfg = st.cfg
    c1 = b1_regions(rv, st)
    build = rv.fwd_build(cfg.channels, cfg.tile_size, dense=rv.bwd_dense(cfg))
    tail = None if time_tail is None else longest_tile_ms(
        c1, st.masks, time_tail, lambda m: rv.raster_fwd(
            st.b.S, st.b.starts, m, cfg, order=st.runs))
    return work_summary(c1, build, cfg, ptxas,
                        ("chm", "ppt", "max_threads", "min_blocks"), tail)


def b5_work(r2, st, ptxas=None, time_tail=None):
    """b1_work for B5 on a Stages2DGS's inputs (r2.fwd_build), with the
    (pair, warp) whose cell meets the region's box."""
    cfg = st.cfg
    c5 = b5_regions(r2, st)
    build = r2.fwd_build(cfg.channels, cfg.tile_size)
    tail = None if time_tail is None else longest_tile_ms(
        c5, st.masks, time_tail,
        lambda m: r2.raster_fwd_2dgs(st.b.S, st.b.starts, m, cfg, st.zch))
    return work_summary(c5, build, cfg, ptxas,
                        ("cbm", "ppt", "max_threads", "min_blocks"), tail)


def expand_bytes(rv, b, cfg):
    """B3's bytes bound at a binning's inputs: the Gaussians whose rows lie
    below n_isects (rv.expand_gaussians; the invisible ones are never read)
    read once, their cum, base and nx and their table columns, and every
    key and output row written once."""
    return ((12 + 4 * cfg.n_attr_eff) * rv.expand_gaussians(b.cum,
                                                            b.n_isects)
            + 4 * cfg.cap + 4 * cfg.d_s * cfg.cap)


def b3_work(rv, st):
    """B3's work in its block layout (rv.expand_counts: rows in range and
    past n_isects, the Gaussians they read, each block's window of
    Gaussians, the longest run, the culled pairs) with its time and bound
    at a Stages' (or Stages2DGS') inputs."""
    b, cfg = st.b, st.cfg
    w = rv.expand_counts(b.cum, b.n_isects, cfg, tile=b.tile)
    w.update(bound(dict(
        ms=cuda_ms(lambda: rv.expand(b.cum, b.base, b.nx, b.table,
                                     b.n_isects, cfg), 10),
        ops=0, bytes=expand_bytes(rv, b, cfg))))
    return w


def garden_recipe(dev, errs, perf, codec_runs):
    """The rest of the garden recipe (examples/garden_benchmark.py) on the
    train phase's checkpoint stand-in: MCMC at 120,000 slots under
    SelectiveAdam and the hash-grid entropy model, the gates at
    LADDER_GATE, RECIPE_STEPS steps with a checkpoint at the middle;
    run_compression("png") of the trained scene and the decode of the
    committed bitstream; the middle checkpoint reloaded into a fresh
    Runner and the committed JAX checkpoint loaded; then, on steps taken
    after all that (outside train(), so with no refine or capacity
    growth), SelectiveAdam's kernel against its plain version on every
    group (the recipe's own visibility), the step's device profile and the
    hash-grid model timed alone. Fills perf and errs under
    "selective_adam"; appends to codec_runs the entropy_codec phase's
    Gaussian-context run on the trained scene (after the PNG codec's);
    returns (phase dict, launches of the run)."""
    from gscodec_studio_tpu_torch.compression import PngCompression
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.optimizers import builders
    from gscodec_studio_tpu_torch.optimizers.selective_adam import (
        selective_adam_bytes, selective_adam_plain, selective_adam_step)
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner
    from gscodec_studio_tpu_torch.utils.scenes import checkpoint_stand_in

    t0 = time.perf_counter()
    parser, trainset, valset = checkpoint_stand_in(
        CHECKPOINT, n_views=8, width=WIDTH, height=HEIGHT, device=dev)
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_recipe_")
    mid = RECIPE_STEPS // 2
    gcfg = Config(result_dir=stats_dir, strategy="mcmc",
                  mcmc_cap_max=LADDER_CAP, compression_sim=True,
                  entropy_model_opt=True, entropy_model_type="gaussian_model",
                  shN_ada_mask_opt=True, visible_adam=True, opacity_reg=0.01,
                  scale_reg=0.01, refine_start_iter=5, refine_every=10,
                  sh_degree_interval=5, save_steps=(mid,), tb_every=0,
                  skip_probe=False)
    runner = Runner(gcfg, parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    runner.compression_sim.entropy_steps = {
        k: LADDER_GATE for k in runner.compression_sim.entropy_steps}
    runner.compression_sim.ada_mask_start = LADDER_GATE
    n_sim = sum(v.numel() for v in runner.sim_params.values())
    saved = {}
    save = runner.save_checkpoint

    def save_and_keep(step):  # the state the middle checkpoint holds
        saved["path"] = save(step)
        saved["splats"] = {k: v.clone() for k, v in runner.splats.items()}
        saved["sim"] = {k: v.clone() for k, v in runner.sim_params.items()}
        return saved["path"]

    runner.save_checkpoint = save_and_keep
    steps = []
    train_step = runner.train_step

    def timed_step(idx, sh_degree, step=0):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = train_step(idx, sh_degree, step)  # ends in a host sync
        e1.record()
        e1.synchronize()
        steps.append(dict(out, ms=e0.elapsed_time(e1)))
        return out

    runner.train_step = timed_step
    before = runner.eval("before")
    t1 = time.perf_counter()
    rv.reset_launch_counts()
    losses = runner.train(max_steps=RECIPE_STEPS, log_every=0)
    torch.cuda.synchronize()
    launches = dict(rv.LAUNCHES)
    train_s = time.perf_counter() - t1
    runner.train_step = train_step
    after = runner.eval("after")
    gated = losses[LADDER_GATE + 1:]
    bits = [s_["bits"] for s_ in steps]
    if not np.mean(gated[-5:]) < np.mean(gated[:5]):
        raise AssertionError(f"garden_recipe loss did not fall: {losses}")
    if not after["psnr"] > before["psnr"]:
        raise AssertionError(f"garden_recipe held-out PSNR did not rise: "
                             f"{before} -> {after}")
    if runner.skipped_steps or not all(math.isfinite(b_) for b_ in bits) \
            or min(bits[LADDER_GATE + 1:]) <= 0:
        raise AssertionError(f"garden_recipe skipped {runner.skipped_steps}"
                             f" steps, bits {bits}")
    if launches["selective_adam"] != 6 * RECIPE_STEPS or min(
            launches[k] for k in KERNELS_3DGS) < 1:
        raise AssertionError(f"garden_recipe launches: {launches}")
    with torch.no_grad():
        extremes = {k: [float(runner.splats[k].min()),
                        float(runner.splats[k].max())]
                    for k in ("means", "scales")}

    # the PNG codec on the trained scene, then the committed bitstream
    metrics = runner.run_compression(RECIPE_STEPS, method="png")
    out_dir = Path(stats_dir) / f"compression_{RECIPE_STEPS}"
    meta = json.loads((out_dir / "meta.json").read_text())
    if not (math.isfinite(metrics["psnr"]) and metrics["size_bytes"] > 0
            and metrics["psnr"] > after["psnr"] - 3.0):
        raise AssertionError(f"run_compression: {metrics} after {after}")
    png_seconds = runner.compression_seconds
    codec_runs.append(entropy_codec_run(runner, dev, "gaussian",
                                        RECIPE_STEPS + 1))
    codec_runs[-1]["png_size_bytes"] = metrics["size_bytes"]
    t1 = time.perf_counter()
    decoded = PngCompression(device=dev).decompress(str(BITSTREAM))
    decode_s = time.perf_counter() - t1
    backup = runner.splats
    runner.splats = {k: torch.as_tensor(v, device=dev)
                     for k, v in decoded.items()}
    try:
        committed_eval = runner.eval("committed_bitstream")
    finally:
        runner.splats = backup
    if not committed_eval["psnr"] > 15:
        raise AssertionError(f"committed bitstream decodes to "
                             f"{committed_eval}")

    # the middle checkpoint into a fresh Runner; the committed one
    fresh = Runner(gcfg, parser=parser, trainset=trainset, valset=valset,
                   device=dev)
    if fresh.load_checkpoint(saved["path"]) != mid or not all(
            torch.equal(fresh.splats[k], v)
            for k, v in saved["splats"].items()) or not all(
            torch.equal(fresh.sim_params[k], v)
            for k, v in saved["sim"].items()):
        raise AssertionError("garden_recipe: the middle checkpoint did not "
                             "reload with the same bits")
    del fresh, saved["splats"], saved["sim"]
    ccfg = dataclasses.replace(gcfg, entropy_model_type="factorized_model",
                               visible_adam=False, save_steps=())
    committed = Runner(ccfg, parser=parser, trainset=trainset,
                       valset=valset, device=dev)
    with np.load(COMMITTED_CKPT) as z:
        step_c = committed.load_checkpoint(str(COMMITTED_CKPT))
        if step_c != int(z["step"]) or not all(
                np.array_equal(v.cpu().numpy(), z[f"splats/{k}"])
                for k, v in committed.splats.items()) or not np.array_equal(
                committed.sim_params["ada_mask"].cpu().numpy(), z["sim/0"]):
            raise AssertionError("garden_recipe: ckpt_750.npz did not load "
                                 "bit for bit")
        n_leaves = sum(1 for k in z.files if k.startswith("sim/"))
    del committed

    # one more step: each group's kernel launch against its plain version
    # on copies of the same inputs (the recipe's visibility); both timed
    # on the device with the host's launches queued ahead (queued_ms: a
    # wrapper call is host-bound at this size), and the wrapper's calls
    # back to back (cuda_ms)
    groups = []  # in the order apply_updates takes the splat groups

    def checked_step(p, g, mu, nu, vis, lr, b1, b2, eps):
        ref = [t.clone() for t in (p, g, mu, nu)]
        work = [t.clone() for t in (p, g, mu, nu)]
        selective_adam_plain(*ref, vis, lr, b1, b2, eps)
        selective_adam_step(p, g, mu, nu, vis, lr, b1, b2, eps)
        torch.cuda.synchronize()
        pairs = list(zip((p, mu, nu), (ref[0], ref[2], ref[3])))
        diff = max(float((a - b).abs().max()) if a.numel() else 0.0
                   for a, b in pairs)
        groups.append(dict(
            shape=list(p.shape), same_bits=all(torch.equal(a, b)
                                               for a, b in pairs),
            max_abs_err=diff, visible_share=float(vis.float().mean()),
            ms=queued_ms(lambda: selective_adam_step(
                *work, vis, lr, b1, b2, eps), 20),
            plain_ms=queued_ms(lambda: selective_adam_plain(
                *work, vis, lr, b1, b2, eps), 20),
            wrapper_ms=cuda_ms(lambda: selective_adam_step(
                *work, vis, lr, b1, b2, eps), 20),
            bytes=selective_adam_bytes(p, vis)))
        del ref, work

    builders.selective_adam_step = checked_step
    try:
        runner.train_step([0], 3, RECIPE_STEPS)
    finally:
        builders.selective_adam_step = selective_adam_step
    if len(groups) != 6 or not all(v["same_bits"] for v in groups):
        raise AssertionError(f"selective_adam differs from its plain version "
                             f"on the recipe's groups: {groups}")
    # the kernel's numbers are one step's: its six launches, summed
    total = bound(dict(ms=sum(v["ms"] for v in groups),
                       plain_ms=sum(v["plain_ms"] for v in groups),
                       wrapper_ms=sum(v["wrapper_ms"] for v in groups),
                       library_ms=None, bytes=sum(v["bytes"] for v in groups),
                       ops=0))
    perf["selective_adam"] = total
    note_err(errs, ["selective_adam"],
             max(v["max_abs_err"] for v in groups))

    # where a step's time goes: the device's busy share, and the hash-grid
    # model (its three attributes' bits forward and backward, and the sim
    # parameters' Adam) timed alone
    profiles = {}
    for view in (0, 1):
        prof = device_profile(lambda: train_step([view], 3, RECIPE_STEPS),
                              reps=1)
        profiles[view] = dict(prof, top=prof.get("top", [])[:8])
    sim = runner.compression_sim
    sp = {k: v.detach() for k, v in runner.splats.items()}

    def hash_grid_fwd_bwd():
        prm = {k: v.detach().requires_grad_(True)
               for k, v in runner.sim_params.items()}
        _, b_, _ = sim.simulate(sp, prm, RECIPE_STEPS, runner.generator)
        torch.autograd.grad(b_, [v for k, v in prm.items()
                                 if k.startswith("entropy.")])

    hash_ms = median_ms(hash_grid_fwd_bwd, 5)[0]
    # the grid's gather and its backward, as hash_grid_encode takes it (one
    # index_select over the levels) beside a gather by advanced indexing
    # level by level, on one attribute's 3D grid and a step's indices
    table = runner.sim_params["entropy.quats.grid3d"].detach()
    L, T, F = table.shape
    g_idx = torch.randint(0, T, (L, 8 * sim.gaussian_sample),
                          generator=runner.generator, device=dev)
    flat_idx = (g_idx + T * torch.arange(L, device=dev)[:, None]).reshape(-1)

    def gather_bwd(advanced):
        t = table.clone().requires_grad_(True)
        emb = torch.cat([t[lvl][g_idx[lvl]] for lvl in range(L)]) \
            if advanced else torch.index_select(t.reshape(-1, F), 0, flat_idx)
        torch.autograd.grad(emb.sum(), t)

    gather_ms = {"index_select": median_ms(lambda: gather_bwd(False), 5)[0],
                 "advanced_indexing": median_ms(lambda: gather_bwd(True),
                                                3)[0]}
    grads = {k: torch.zeros_like(v) for k, v in runner.sim_params.items()}
    sim_adam_ms = median_ms(lambda: builders.apply_updates(
        runner.sim_groups, runner.sim_states, runner.sim_params, grads), 5)[0]
    step_ms = float(np.median([s_["ms"] for s_ in steps]))
    phase = {
        "phase": "garden_recipe", "steps": RECIPE_STEPS,
        "capacity": LADDER_CAP, "entropy_model_type": "gaussian_model",
        "visible_adam": True, "entropy_and_mask_gate": LADDER_GATE,
        "sim_parameters": n_sim,
        "loss_first5": losses[:5], "loss_last5": losses[-5:], "bits": bits,
        "psnr_before": before["psnr"], "psnr_after": after["psnr"],
        "step_ms_median": step_ms, "step_ms": [s_["ms"] for s_ in steps],
        "n_isects": [s_["n_isects"] for s_ in steps],
        "isect_capacity": runner.isect_capacity(), "events": runner.events,
        "splat_extremes": extremes,
        "step_profiles": profiles,
        "device_busy_share": [p_.get("device_busy_share")
                              for p_ in profiles.values()],
        "launches": launches,
        "launches_per_step": {k: v / RECIPE_STEPS
                              for k, v in launches.items() if v},
        "selective_adam": dict(total, launches_per_step=6, groups=groups),
        "visible_share": groups[0]["visible_share"],
        "hash_grid_fwd_bwd_ms": hash_ms, "sim_adam_ms": sim_adam_ms,
        "hash_grid_share_of_step": (hash_ms + sim_adam_ms) / step_ms,
        "hash_grid_gather_fwd_bwd_ms": gather_ms,
        "checkpoint": {"middle_step": mid, "reloaded_same_bits": True,
                       "committed": str(COMMITTED_CKPT.relative_to(ROOT)),
                       "committed_step": step_c,
                       "committed_sim_leaves": n_leaves},
        "compression": {"psnr_trained": after["psnr"],
                        "psnr_after_codec": metrics["psnr"],
                        "ssim_after_codec": metrics["ssim"],
                        "size_bytes": metrics["size_bytes"],
                        "side": meta["side"],
                        "shN_k": meta["attrs"]["shN"].get("k"),
                        "seconds": png_seconds},
        "committed_bitstream": {"dir": str(BITSTREAM.relative_to(ROOT)),
                                "psnr": committed_eval["psnr"],
                                "ssim": committed_eval["ssim"],
                                "gaussians": int(decoded["means"].shape[0]),
                                "decode_seconds": decode_s},
        "train_seconds": train_s, "seconds": time.perf_counter() - t0,
    }
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)
    return phase, launches


def rotmat_to_qvec(R):
    """Rotation matrix -> COLMAP's unit quaternion (w, x, y, z), w >= 0."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    return np.array([w, math.copysign(x, R[2, 1] - R[1, 2]),
                     math.copysign(y, R[0, 2] - R[2, 0]),
                     math.copysign(z, R[1, 0] - R[0, 1])])


def write_colmap_scene(root, parser):
    """The checkpoint stand-in as a COLMAP directory: sparse/0 in binary
    (a PINHOLE camera per view; each view's pose and its 2D tracks, the
    live means that project into it in front of the camera; the means as
    points3D with their colours and tracks) and images/ (the targets as
    8-bit PNGs, by the port's writer). Returns the tracks per view."""
    from gscodec_studio_tpu_torch.compression.png_io import write_png

    sparse = Path(root) / "sparse" / "0"
    images = Path(root) / "images"
    sparse.mkdir(parents=True)
    images.mkdir()
    xyz = np.asarray(parser.points, np.float64)
    rgb = np.clip(np.rint(np.asarray(parser.points_rgb)), 0, 255).astype(
        np.uint8)
    n_views = len(parser.camtoworlds)
    cams, views, tracks = [], [], [[] for _ in range(len(xyz))]
    for i in range(n_views):
        img = parser.images[i].detach().cpu().numpy()
        H, W = img.shape[:2]
        K = np.asarray(parser.Ks[i], np.float64)
        cams.append(struct.pack("<iiQQ4d", i + 1, 1, W, H, K[0, 0], K[1, 1],
                                K[0, 2], K[1, 2]))
        w2c = np.linalg.inv(np.asarray(parser.camtoworlds[i], np.float64))
        pc = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = (pc @ K.T)[:, :2] / pc[:, 2:3]
        seen = np.nonzero((pc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                          & (uv[:, 1] >= 0) & (uv[:, 1] < H))[0]
        rec = np.zeros(len(seen), [("x", "<f8"), ("y", "<f8"),
                                   ("id", "<i8")])
        rec["x"], rec["y"], rec["id"] = uv[seen, 0], uv[seen, 1], seen + 1
        for k, j in enumerate(seen):
            tracks[j].append((i + 1, k))
        name = f"view_{i:02d}.png"
        views.append(struct.pack("<i4d3di", i + 1,
                                 *rotmat_to_qvec(w2c[:3, :3]), *w2c[:3, 3],
                                 i + 1) + name.encode() + b"\x00"
                     + struct.pack("<Q", len(seen)) + rec.tobytes())
        write_png(str(images / name),
                  np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))
    (sparse / "cameras.bin").write_bytes(struct.pack("<Q", n_views)
                                         + b"".join(cams))
    (sparse / "images.bin").write_bytes(struct.pack("<Q", n_views)
                                        + b"".join(views))
    pts = [struct.pack("<Q", len(xyz))]
    for j in range(len(xyz)):
        pts.append(struct.pack("<Q3d3BdQ", j + 1, *xyz[j], *rgb[j], 0.5,
                               len(tracks[j]))
                   + np.asarray(tracks[j], "<i4").tobytes())
    (sparse / "points3D.bin").write_bytes(b"".join(pts))
    return [sum(1 for t in tracks if any(v == i + 1 for v, _ in t))
            for i in range(n_views)]


def colmap_trainer(dev, stages_for):
    """The static trainer from a COLMAP scene through its command line: the
    train phase's stand-in (8 views at 1297x840) written as a COLMAP
    directory, trained COLMAP_STEPS steps by simple_trainer.main with the
    pose deltas, appearance, the bilateral grid, the depth loss, scalars
    and histograms every 10 steps, render dumps and a checkpoint inside
    the run; then an 8-frame trajectory, the final checkpoint reloaded
    into a fresh Runner bit for bit, a step poisoned through one pose row
    (skips.jsonl and its probe), and 5 steps from init_type="random" at
    100,000 points. The first step's B9a, B3, B1, B2, B9b and B4 are held
    against their plain versions at its 4 channels (RGB+ED) and per-camera
    colours, with errors of their own. Returns (phase dict, launches of the
    run, the six kernels' largest absolute errors there)."""
    from gscodec_studio_tpu_torch import simple_trainer
    from gscodec_studio_tpu_torch.datasets.colmap import Parser
    from gscodec_studio_tpu_torch.models.splats import splat_activations
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.rendering import project_and_shade
    from gscodec_studio_tpu_torch.training import trainer as tt
    from gscodec_studio_tpu_torch.utils.bilagrid import (bilagrid_slice,
                                                         bilagrid_tv_loss)
    from gscodec_studio_tpu_torch.utils.camera_opt import (
        appearance_opt_apply, camera_opt_apply)
    from gscodec_studio_tpu_torch.utils.scenes import checkpoint_stand_in

    t0 = time.perf_counter()
    stand_in, _, _ = checkpoint_stand_in(CHECKPOINT, n_views=8, width=WIDTH,
                                         height=HEIGHT, device=dev)
    work = Path(tempfile.mkdtemp(prefix="gsc_smoke_colmap_"))
    scene, out = work / "scene", work / "run"
    t1 = time.perf_counter()
    view_tracks = write_colmap_scene(scene, stand_in)
    write_s = time.perf_counter() - t1
    del stand_in
    t1 = time.perf_counter()
    parsed = Parser(str(scene), factor=1, load_points2d=True)
    parse_s = time.perf_counter() - t1
    n_points = len(parsed.points)
    del parsed

    steps, first, load = [], {}, {}
    train_step, device_trainset = tt.Runner.train_step, \
        tt.Runner._device_trainset

    def timed_step(self, idx, sh_degree, step=0):
        if not first:  # the first step's inputs, for the kernel check
            first.update(
                idx=list(idx), sh_degree=sh_degree,
                splats={k: v.detach().clone() for k, v in self.splats.items()},
                aux={k: v.detach().clone() for k, v in
                     self.aux_params.items()})
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = train_step(self, idx, sh_degree, step)  # ends in a host sync
        e1.record()
        e1.synchronize()
        steps.append(dict(res, ms=e0.elapsed_time(e1)))
        return res

    def timed_trainset(self):
        if self._data is None:
            t_ = time.perf_counter()
            data = device_trainset(self)
            torch.cuda.synchronize()
            load["seconds"] = time.perf_counter() - t_
            return data
        return device_trainset(self)

    argv = ["default", "--data-dir", str(scene), "--data-factor", "1",
            "--result-dir", str(out), "--max-steps", str(COLMAP_STEPS),
            "--pose-opt", "--app-opt", "--use-bilateral-grid",
            "--depth-loss", "--tb-every", "10", "--tb-histograms-every",
            "10", "--eval-save-images", "--eval-steps", "1",
            "--save-steps", str(COLMAP_STEPS // 2), "--refine-start-iter",
            "5", "--refine-every", "10", "--sh-degree-interval", "5"]
    tt.Runner.train_step, tt.Runner._device_trainset = timed_step, \
        timed_trainset
    try:
        rv.reset_launch_counts()
        t1 = time.perf_counter()
        runner = simple_trainer.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t1
        launches = dict(rv.LAUNCHES)
    finally:
        tt.Runner.train_step, tt.Runner._device_trainset = train_step, \
            device_trainset
    cfg = runner.cfg
    losses = [s_["loss"] for s_ in steps]
    stats = {p_.stem: json.loads(p_.read_text())
             for p_ in (out / "stats").glob("*.json")}
    if len(steps) != COLMAP_STEPS or runner.skipped_steps or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"colmap_trainer: {len(steps)} steps, skipped "
                             f"{runner.skipped_steps}, losses {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"colmap_trainer loss did not fall: {losses}")
    if not stats["val"]["psnr"] > stats["val_step1"]["psnr"]:
        raise AssertionError(f"colmap_trainer held-out PSNR did not rise: "
                             f"{stats}")
    if min(launches[k] for k in KERNELS_3DGS) < 1:
        raise AssertionError(f"colmap_trainer: a kernel did not launch: "
                             f"{launches}")
    init = first["aux"]
    moved = {k: not torch.equal(v, init[k])
             for k, v in runner.aux_params.items()}
    if not all(moved.values()) or sorted(moved) != [
            "app_embeds", "app_mlp.0.b", "app_mlp.0.w", "app_mlp.1.b",
            "app_mlp.1.w", "bilagrid", "pose"]:
        raise AssertionError(f"colmap_trainer: per-image modules {moved}")

    # the final checkpoint into a fresh Runner, before any more steps
    ckpt = out / "ckpts" / f"ckpt_{COLMAP_STEPS}.npz"
    fresh = tt.Runner(cfg, parser=runner.parser, trainset=runner.trainset,
                      valset=runner.valset, device=dev)
    if fresh.load_checkpoint(str(ckpt)) != COLMAP_STEPS:
        raise AssertionError("colmap_trainer: the checkpoint's step")
    with np.load(ckpt) as z:
        n_aux = sum(1 for k in z.files if k.startswith("aux/"))
    if n_aux != 7 or not all(torch.equal(fresh.aux_params[k], v)
                             for k, v in runner.aux_params.items()) \
            or not all(torch.equal(fresh.splats[k], v)
                       for k, v in runner.splats.items()):
        raise AssertionError("colmap_trainer: the checkpoint's aux leaves "
                             "did not reload with the same bits")
    del fresh

    # B9a, B3, B1, B2, B9b and B4 on the first step's own inputs: the
    # posed camera, the appearance colours and the depth channel
    data = runner._device_trainset()
    H, W = data["image"].shape[1:3]
    sel = torch.as_tensor(first["idx"], device=dev)
    sp, aux = first["splats"], first["aux"]
    with torch.no_grad():
        c2w = camera_opt_apply(aux["pose"], data["camtoworld"][sel], sel)
        means, quats, scales, opac = splat_activations(sp)
        colors = torch.sigmoid(appearance_opt_apply(
            aux["app_embeds"], runner.app_mlp(aux), sp["features"], sel,
            means[None] - c2w[:, None, :3, 3], first["sh_degree"],
            sh_degree_max=cfg.sh_degree) + sp["colors"][None])
        prep = list(project_and_shade(
            means, quats, scales, opac, colors, torch.linalg.inv(c2w),
            data["K"][sel], W, H, near_plane=cfg.near_plane,
            far_plane=cfg.far_plane, sh_degree=None))
        prep[4] = torch.cat([prep[4], prep[2][..., None]], -1)  # + depth
        st = stages_for(prep, W, H, cfg.tile_size, cfg.cutoff_mode,
                        cap=runner.isect_capacity())
        if st.cfg.channels != 4:
            raise AssertionError(f"RGB+ED renders {st.cfg.channels} channels")
        # their own errors: the depth channel's seeded cotangent makes
        # gradients of ~1e7, whose absolute errors (relative ones within
        # BWD_TOL and the sums' bound) would mask the other phases'
        own = {}
        check = st.compare(own)
        check.update(st.compare_bwd(own, seed=500, absgrads=(False,)))
        check["n_isects"] = int(st.b.n_isects)
        del st
    rgb_ed_errs = {k: own[k] for k in KERNELS_3DGS}

    # where a step's time goes: the device's busy share, and each module's
    # forward and backward at the step's shapes, each under the profiler
    view = first["idx"]
    step_prof = device_profile(lambda: runner.train_step(
        view, cfg.sh_degree, COLMAP_STEPS), reps=2)
    sel = torch.as_tensor(view, device=dev)
    prm = {k: v.detach() for k, v in runner.splats.items()}
    ax = {k: v.detach().requires_grad_(True)
          for k, v in runner.aux_params.items()}
    c2w0 = data["camtoworld"][sel]
    feats = prm["features"].requires_grad_(True)
    img = data["image"][sel].clone().requires_grad_(True)
    dmap = torch.rand((1, H, W, 1), device=dev) * 3 + 0.5
    dmap.requires_grad_(True)
    pts, deps = data["points"][sel], data["depths"][sel]

    def pose_fb():
        torch.autograd.grad(camera_opt_apply(ax["pose"], c2w0, sel).sum(),
                            ax["pose"])

    def app_fb():
        dirs = prm["means"][None] - c2w0[:, None, :3, 3]
        col = torch.sigmoid(appearance_opt_apply(
            ax["app_embeds"], runner.app_mlp(ax), feats, sel, dirs,
            cfg.sh_degree, sh_degree_max=cfg.sh_degree)
            + prm["colors"][None])
        torch.autograd.grad(col.sum(), [feats, ax["app_embeds"]]
                            + [v for k, v in ax.items()
                               if k.startswith("app_mlp")])

    def grid_fb():
        loss = bilagrid_slice(ax["bilagrid"], sel, img).sum() \
            + 10.0 * bilagrid_tv_loss(ax["bilagrid"])
        torch.autograd.grad(loss, [ax["bilagrid"], img])

    def depth_fb():
        torch.autograd.grad(tt._depth_l1(dmap, pts, deps), dmap)

    modules = {}
    for name, fn in (("pose", pose_fb), ("appearance_mlp", app_fb),
                     ("bilateral_grid", grid_fb), ("depth_sampling",
                                                   depth_fb)):
        prof = device_profile(fn, reps=5)
        modules[name] = dict(device_ms=prof.get("device_ms_per_call"),
                             event_ms=median_ms(fn, 5)[0],
                             top=prof.get("top", [])[:3])
    step_dev_ms = step_prof.get("device_ms_per_call")
    for v in modules.values():
        v["share_of_step_device_time"] = (
            v["device_ms"] / step_dev_ms if step_dev_ms and v["device_ms"]
            else None)

    # an 8-frame trajectory
    t1 = time.perf_counter()
    traj = runner.render_traj(COLMAP_STEPS, "interp", n_frames=8)
    traj_s = time.perf_counter() - t1
    frames = sorted(os.listdir(traj)) if os.path.isdir(traj) else [traj]
    if os.path.isdir(traj) and len(frames) != 8:
        raise AssertionError(f"render_traj wrote {frames}")
    # a step poisoned through the pose row of the first view of the order
    row = runner.view_order[0]
    saved = runner.aux_params["pose"].clone()
    runner.aux_params["pose"][row] = float("nan")
    runner.train(max_steps=1, log_every=0)
    runner.aux_params["pose"] = saved
    skips = [json.loads(line) for line in
             (out / "skips.jsonl").read_text().splitlines()]
    if len(skips) != 1 or "[2]['pose']" not in skips[0]["bad_leaves"] \
            or skips[0].get("probe") != tt.PROBE_VERDICTS[0]:
        raise AssertionError(f"colmap_trainer: skips.jsonl {skips}")
    rows = [json.loads(line) for line in
            (out / "tb" / "scalars.jsonl").read_text().splitlines()]
    n_hist = sum(1 for r in rows if "hist" in r)
    if n_hist != 9 or len(rows) - n_hist < 6:
        raise AssertionError(f"colmap_trainer: scalars.jsonl rows {rows}")

    # 5 steps from init_type="random" at 100,000 points (on the loaded
    # views: the same files)
    rcfg = dataclasses.replace(cfg, init_type="random",
                               init_num_pts=100_000,
                               result_dir=str(work / "random"))
    rr = tt.Runner(rcfg, parser=runner.parser, trainset=runner.trainset,
                   valset=runner.valset, device=dev)
    rr._data = data
    t1 = time.perf_counter()
    r_losses = rr.train(max_steps=5, log_every=0)
    torch.cuda.synchronize()
    random_s = time.perf_counter() - t1
    if rr.skipped_steps or not all(math.isfinite(v) for v in r_losses) \
            or rr.splats["means"].shape[0] != 400_000:
        raise AssertionError(f"init_type=random: losses {r_losses}, "
                             f"skipped {rr.skipped_steps}")
    del rr

    files = sorted(str(p_.relative_to(out)) for p_ in out.rglob("*")
                   if p_.is_file())
    step_ms = float(np.median([s_["ms"] for s_ in steps]))
    phase = {
        "phase": "colmap_trainer", "views": 8, "train_views":
        len(runner.trainset), "width": WIDTH, "height": HEIGHT,
        "points3D": n_points, "tracks_per_view": view_tracks,
        "depth_points_cap": cfg.depth_points_cap,
        "capacity": runner.splats["means"].shape[0],
        "isect_capacity": runner.isect_capacity(), "argv": argv,
        "write_colmap_seconds": write_s, "parse_seconds": parse_s,
        "image_load_seconds": load.get("seconds"),
        "loss_first5": losses[:5], "loss_last5": losses[-5:],
        "psnr_step1": stats["val_step1"]["psnr"],
        "psnr_after": stats["val"]["psnr"], "ssim_after": stats["val"]["ssim"],
        "step_ms_median": step_ms, "step_ms": [s_["ms"] for s_ in steps],
        "n_isects": [s_["n_isects"] for s_ in steps],
        "events": runner.events, "launches": launches,
        "launches_per_step": {k: v / COLMAP_STEPS
                              for k, v in launches.items() if v},
        "rgb_ed_check": check, "step_profile": dict(
            step_prof, top=step_prof.get("top", [])[:8]),
        "device_busy_share": step_prof.get("device_busy_share"),
        "aux_modules": modules,
        "scalar_rows": len(rows) - n_hist, "histogram_rows": n_hist,
        "skip_rows": len(skips), "skip_row": skips[0],
        "tensorboard_events": any("tfevents" in f_ for f_ in files),
        "trajectory": {"path": os.path.relpath(traj, out),
                       "frames": len(frames), "seconds": traj_s},
        "checkpoint_aux_leaves": n_aux,
        "random_init": {"points": 100_000, "losses": r_losses,
                        "seconds": random_s},
        "files": files, "main_seconds": main_s,
        "seconds": time.perf_counter() - t0,
    }
    del runner
    shutil.rmtree(work, ignore_errors=True)
    return phase, launches, rgb_ed_errs


# the dynamic phase: examples/dyn_benchmark.py's recipe on a stand-in made
# from the serve checkpoint (its inputs, the garden SfM points and views,
# are not in the repository)
DYN_WIDTH, DYN_HEIGHT = 648, 420
DYN_VIEWS, DYN_FRAMES = 10, 20
DYN_SEED = 0  # the stand-in's motion and the initialisation's draws
DYN_CAP = 120_000
DYN_STEPS = 200  # the recipe's 4,000, cut
DYN_REFINE = (50, 50, 167)  # start, every, stop: 25/30 of the run
DYN_ENTROPY_AT = 100  # the STG entropy terms' step (7,000 in the recipe)
DYN_STG_STEPS, DYN_STG_FREEZE = 40, 20
DYN_CLI_STEPS, DYN_V1_STEPS = 20, 5
DYN_RATE_POINTS = ("rp0", "rp2", "rp3")
DYN_COMMITTED = ROOT / "results" / "dyn_stand_in"
# the kernels of the dynamic path: the fused step's, and the v1 leg's
DYN_KERNELS = ("pack_rows", "expand", "raster_fwd", "raster_bwd",
               "segsum_rows", "unpack_rows", "raster_v1_fwd",
               "raster_v1_bwd", "cumsum_rows")


def dyn_stand_in(dev):
    """The dynamic stand-in: the serve checkpoint's 120,000 Gaussians (SH
    3) as the ground truth, 30% of them moving 0.15 U(0,1) sin(2 pi t)
    along a random axis; DYN_VIEWS cameras on dyn_benchmark.py's arc (phi
    in [-0.5, 0.5] around the live points' median, at orbit_cameras'
    radius and elevation) x DYN_FRAMES timestamps, rendered by the port's
    fused forward with orbit_cameras' K at DYN_WIDTH x DYN_HEIGHT. Returns
    (samples, the live points, their colours in [0, 1])."""
    from gscodec_studio_tpu_torch.models.splats import (from_jax_splats,
                                                        sh_to_rgb,
                                                        splat_activations)
    from gscodec_studio_tpu_torch.rendering import rasterization
    from gscodec_studio_tpu_torch.utils.ply_render import orbit_cameras

    with np.load(CHECKPOINT) as z:
        ck = {k: z[k] for k in z.files}
    model = from_jax_splats(ck, device=dev)
    N = len(ck["means"])
    rng = np.random.default_rng(DYN_SEED)
    moving = rng.random(N) < 0.3
    axis = rng.standard_normal((N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    amp = (0.15 * rng.random(N) * moving).astype(np.float32)
    live = 1.0 / (1.0 + np.exp(-ck["opacities"].astype(np.float64))) > 0.005
    pts = ck["means"][live].astype(np.float32)
    rgb = np.clip(sh_to_rgb(ck["sh0"].reshape(-1, 3)[live]), 0, 1).astype(
        np.float32)
    cam0 = orbit_cameras(pts, n_views=1, width=DYN_WIDTH,
                         height=DYN_HEIGHT)[0]
    K = cam0["K"]
    target = np.median(pts, axis=0)
    radius = float(np.linalg.norm(cam0["camtoworld"][:3, 3] - target)) \
        / float(np.linalg.norm([1.0, 0.15]))
    means0, quats, scales, opac = splat_activations(model)
    colors = model.sh_coeffs()
    axis_d, amp_d = (torch.as_tensor(a, device=dev) for a in (axis, amp))
    samples = []
    with torch.no_grad():
        for vi in range(DYN_VIEWS):
            phi = -0.5 + 1.0 * vi / max(DYN_VIEWS - 1, 1)
            eye = target + radius * np.array([np.cos(phi), 0.15,
                                              np.sin(phi)], np.float32)
            fwd = target - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(fwd, np.array([0, -1, 0], np.float32))
            right /= np.linalg.norm(right)
            up = np.cross(fwd, right)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, up,
                                                              fwd, eye)
            vm = torch.as_tensor(np.linalg.inv(c2w), device=dev)[None]
            for fi in range(DYN_FRAMES):
                t = fi / max(DYN_FRAMES - 1, 1)
                disp = (amp_d * math.sin(2 * math.pi * t))[:, None] * axis_d
                img, _, meta = rasterization(
                    means0 + disp, quats, scales, opac, colors, vm,
                    torch.as_tensor(K, device=dev)[None], DYN_WIDTH,
                    DYN_HEIGHT, sh_degree=3, isect_capacity=1 << 20,
                    device=dev)
                if int(meta["n_isects"][0]) >= (1 << 20):
                    raise AssertionError("a dynamic target filled its "
                                         "intersection capacity")
                samples.append({
                    "camtoworld": c2w, "K": K, "timestamp": np.float32(t),
                    "image": torch.clamp(img[0], 0, 1).cpu().numpy(),
                    "image_id": len(samples), "view": vi})
    return samples, pts, rgb


def dyn_view_prep(runner, sp, i, sim_step=None):
    """project_and_shade's outputs of train sample ``i`` at splats ``sp``
    as DynRunner renders them (the simulation's fake quantization at
    ``sim_step`` first, where given)."""
    from gscodec_studio_tpu_torch.rendering import project_and_shade

    cfg = runner.cfg
    data = runner._device_trainset()
    c2w, K, t = (data[k][i] for k in ("camtoworld", "K", "timestamp"))
    H, W = data["image"].shape[1:3]
    if sim_step is not None and runner.compression_sim is not None:
        sp, _, _ = runner.compression_sim.simulate(sp, runner.sim_params,
                                                   sim_step)
    means, quats, scales, opac, colors, _ = runner.render_inputs(sp, c2w, t)
    return project_and_shade(
        means, quats, scales, opac, colors, torch.linalg.inv(c2w)[None],
        K[None], W, H, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        sh_degree=None, elliptical=cfg.rasterizer == "fused")


def dyn_eval(runner):
    """eval() with its intersection counts against the eval capacity."""
    from gscodec_studio_tpu_torch.training import dyn_trainer as dt

    m = runner.eval()
    cap = runner.cfg.isect_capacity or dt.EVAL_ISECT_CAPACITY
    return dict(m, n_isects=runner.eval_isects, isect_capacity=cap,
                truncated_views=sum(n >= cap for n in runner.eval_isects))


def write_invr_scene(root, samples, train_views, val_views, frames, pts):
    """An INVR directory of the stand-in's samples: transforms_train.json
    and transforms_val.json (Blender axes, fl_x/fl_y), PNG frames and the
    initial points (points3d.npy)."""
    from gscodec_studio_tpu_torch.compression.png_io import write_png

    root.mkdir(parents=True)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for split, views in (("train", train_views), ("val", val_views)):
        meta = {"fl_x": float(samples[0]["K"][0, 0]),
                "fl_y": float(samples[0]["K"][1, 1]), "frames": []}
        for s in samples:
            if s["view"] in views and (s["image_id"] % DYN_FRAMES) in frames:
                name = f"frames/{s['image_id']:04d}"
                (root / "frames").mkdir(exist_ok=True)
                write_png(str(root / (name + ".png")),
                          (s["image"] * 255).astype(np.uint8))
                meta["frames"].append({
                    "file_path": name, "time": float(s["timestamp"]),
                    "transform_matrix": (s["camtoworld"].astype(np.float64)
                                         @ flip).tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    np.save(root / "points3d.npy", pts)


def seq_meta_diff(got, want, path=""):
    """The fields of two meta.json trees that differ (file lists apart),
    floats compared at their float32 bits."""
    if isinstance(want, dict) and isinstance(got, dict):
        out = []
        for k in sorted(set(got) | set(want)):
            if k != "files":
                out += seq_meta_diff(got.get(k), want.get(k), f"{path}.{k}")
        return out
    if isinstance(want, list) and isinstance(got, list) \
            and len(got) == len(want):
        return [d for i, (a, b) in enumerate(zip(got, want))
                for d in seq_meta_diff(a, b, f"{path}[{i}]")]
    if isinstance(want, float) or isinstance(got, float):
        same = got is not None and want is not None and \
            np.float32(got) == np.float32(want)
    else:
        same = got == want
    return [] if same else [dict(field=path, got=got, want=want)]


def dynamic(dev, stages_for):
    """The dynamic/STG path (examples/dyn_benchmark.py's recipe) on the
    stand-in of dyn_stand_in. The main leg: DynRunner under ModifiedSTG at
    DYN_CAP slots, the Sandwich decoder (9 feature channels: B1 and B2 in
    their chm-16 builds), the STG compression simulation with its entropy
    models (their gates moved to DYN_ENTROPY_AT), DYN_STEPS steps with the
    refine window cut in proportion, scene_scale 3: step times by CUDA
    events, launches a step, the device's busy share, held-out PSNR/SSIM
    before and after with each view's intersections against the eval
    capacity, the live count after each refine; the kernels B9a, B3, B1,
    B2, B9b and B4 on the slowest trained view (B2 timed on every training
    sample) against their plain versions, B1's and B2's regions there
    (missed_slots must be 0) and their times beside the same view's first
    3 channels. The stg leg (the linear head, the omega freeze at
    DYN_STG_FREEZE), the mcmc leg through dyn_trainer_cli.main on an INVR
    directory written from the stand-in, the v1 leg (rasterizer="pallas",
    B7, B8 and B10 at 9 channels, B7 and B8 against their plain versions).
    The codecs: the trained model's 20 frames through compress_ply_sequence
    at DYN_RATE_POINTS, STGPngCompression of the trained splats, and the
    committed sequence results/dyn_stand_in/frames at qp 30 against the
    committed meta.json. Returns (phase dict, launches a step of the main
    leg and of the v1 leg, the kernels' largest absolute and relative
    errors at 9 channels, kept apart from the other phases': the seeded
    cotangent makes gradients of ~1e7 here)."""
    from gscodec_studio_tpu_torch import compress_ply_sequence
    from gscodec_studio_tpu_torch import dyn_trainer_cli
    from gscodec_studio_tpu_torch.compression import compressed_size
    from gscodec_studio_tpu_torch.compression.seq_codec import (SeqCodec,
                                                                have_ffmpeg)
    from gscodec_studio_tpu_torch.compression.stg_compression import (
        STGPngCompression)
    from gscodec_studio_tpu_torch.models.splats import DEAD_OPACITY_LOGIT
    from gscodec_studio_tpu_torch.ops import isect as ti
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    from gscodec_studio_tpu_torch.training import dyn_trainer as dt
    from gscodec_studio_tpu_torch.utils.ply import load_ply, save_ply

    t0 = time.perf_counter()
    samples, pts, rgb = dyn_stand_in(dev)
    scene_s = time.perf_counter() - t0
    held = set(range(0, DYN_VIEWS, 5))
    train_v = [s for s in samples if s["view"] not in held]
    val_v = [s for s in samples if s["view"] in held][::4]
    rng = np.random.default_rng(DYN_SEED)
    sel = rng.choice(len(pts), min(60_000, len(pts)), replace=False)
    init_pts = pts[sel] + 0.02 * rng.standard_normal(
        (len(sel), 3)).astype(np.float32)
    start, every, stop = DYN_REFINE
    cuts = {
        "ground_truth": "the serve checkpoint results/garden_ab_f32/"
        "splats_final.npz (120,000 slots, SH 3) for dyn_benchmark's 40,000 "
        "garden SfM points at SH 1 (test_garden.npz is not in the repo)",
        "cameras": "dyn_benchmark's arc at orbit_cameras' radius and "
        "elevation around the live points, orbit_cameras' K at "
        f"{DYN_WIDTH}x{DYN_HEIGHT}",
        "init": f"{len(sel)} live means (the checkpoint holds "
        f"{len(pts)} live Gaussians; the recipe takes 60,000) + 0.02 noise",
        "steps": f"{DYN_STEPS} of 4,000", "refine": dict(
            start=start, every=every, stop=stop),
        "entropy_steps": f"{DYN_ENTROPY_AT} (7,000 in the STG tables)",
        "seed": DYN_SEED}
    base = dict(strategy="modified_stg", capacity=DYN_CAP,
                mcmc_cap_max=DYN_CAP, color_mode="sandwich",
                compression_sim=True, entropy_model_opt=True, rd_lambda=0.01,
                max_steps=DYN_STEPS, refine_start_iter=start,
                refine_every=every, refine_stop_iter=stop,
                steps_per_dispatch=10)
    work = Path(tempfile.mkdtemp(prefix="gsc_smoke_dyn_"))

    def runner_for(name, **kw):
        cfg = dt.DynConfig(result_dir=str(work / name), **dict(base, **kw))
        r = dt.DynRunner(cfg, init_pts, rgb[sel], train_v, val_v,
                         scene_scale=3.0, device=dev)
        if r.compression_sim is not None:
            sim = r.compression_sim
            sim.entropy_steps = {k: DYN_ENTROPY_AT for k in sim.entropy_steps}
        return r

    def timed(runner, n):
        """n steps of runner.train with each step between CUDA events;
        returns (losses, step ms, seconds, launches)."""
        events = []
        step_fn = runner.train_step

        def step(idx, s):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step_fn(idx, s)
            e1.record()
            events.append((e0, e1))
            return out

        runner.train_step = step
        rv.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            losses = runner.train(n, log_every=0)
            torch.cuda.synchronize()
        finally:
            del runner.train_step
        secs = time.perf_counter() - t1
        launches = dict(rv.LAUNCHES)
        return (losses, [a.elapsed_time(b) for a, b in events], secs,
                launches)

    # the main leg
    runner = runner_for("main")
    before = dyn_eval(runner)
    losses, step_ms, train_s, launches = timed(runner, DYN_STEPS)
    per_step = {k: v / DYN_STEPS for k, v in launches.items() if v}
    # the losses are not compared: each step renders another view and
    # time, and from DYN_ENTROPY_AT on they carry rd_lambda * bits; the
    # held-out PSNR below must rise
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dynamic: losses {losses}")
    if min(launches.get(k, 0) for k in KERNELS_3DGS) < DYN_STEPS:
        raise AssertionError(f"dynamic: a kernel missed steps: {launches}")
    after = dyn_eval(runner)
    if not after["psnr"] > before["psnr"]:
        raise AssertionError(f"dynamic: held-out PSNR {before} -> {after}")
    sim_bits = None
    with torch.no_grad():
        _, bits, _ = runner.compression_sim.simulate(
            runner.splats, runner.sim_params, DYN_STEPS)
        sim_bits = float(bits)

    # the kernels on the slowest trained view, at 9 channels
    cfg = runner.cfg
    data = runner._device_trainset()
    H, W = data["image"].shape[1:3]
    sp = {k: v.detach() for k, v in runner.splats.items()}
    n_train = data["image"].shape[0]
    bwd_ms = []
    dyn_errs = {}
    with torch.no_grad():
        for i in range(n_train):
            st = stages_for(dyn_view_prep(runner, sp, i, DYN_STEPS - 1), W,
                            H, 16, "exact", cap=runner.isect_capacity())
            st.cotangent(seed=700 + i)
            bwd_ms.append(cuda_ms(lambda: rv.raster_bwd(
                st.b.S, st.b.starts, st.masks, st.out, st.v_tiles, st.cfg,
                False), 2))
            del st
        view = int(np.argmax(bwd_ms))
        prep = dyn_view_prep(runner, sp, view, DYN_STEPS - 1)
        st = stages_for(prep, W, H, 16, "exact", cap=runner.isect_capacity())
        if st.cfg.channels != 9 or rv.fwd_build(9, 16)["chm"] != 16:
            raise AssertionError("the dynamic render is not B1's 9-channel "
                                 "chm-16 build")
        check = st.compare(dyn_errs)
        check.update(st.compare_bwd(dyn_errs, seed=700 + view))
        check["b1_regions"] = region_summary(b1_regions(rv, st))
        check["b2_regions"] = region_summary(b2_regions(rv, st))
        check["b3_work"] = b3_work(rv, st)
        times = {}
        for ch in (9, 3):
            s_ = st if ch == 9 else stages_for(
                prep[:4] + (prep[4][..., :3],) + prep[5:], W, H, 16, "exact",
                cap=runner.isect_capacity())
            s_.cotangent(seed=800)
            times[f"{ch}ch"] = dict(
                channels=ch, build_fwd=rv.fwd_build(ch, 16),
                build_bwd=rv.bwd_build(ch, 16),
                raster_fwd_ms=cuda_ms(lambda: rv.raster_fwd(
                    s_.b.S, s_.b.starts, s_.masks, s_.cfg, order=s_.runs),
                    10),
                raster_bwd_ms=cuda_ms(lambda: rv.raster_bwd(
                    s_.b.S, s_.b.starts, s_.masks, s_.out, s_.v_tiles,
                    s_.cfg, False), 10))
        check.update(view=view, timestamp=float(data["timestamp"][view]),
                     n_isects=int(st.b.n_isects),
                     isect_capacity=st.cfg.cap,
                     out_channels=int(st.out.shape[-1]),
                     b1_b2_by_channels=times)
        del st
    # where a step's time goes
    step_prof = device_profile(lambda: runner.train_step(
        runner.order[0], DYN_STEPS), reps=2)
    main = dict(
        steps=DYN_STEPS, train_seconds=train_s,
        step_ms_median=float(np.median(step_ms)), step_ms_p90=float(
            np.percentile(step_ms, 90)), host_ms_per_step=1e3 * train_s
        / DYN_STEPS, loss_first5=losses[:5], loss_last5=losses[-5:],
        eval_before=before, eval_after=after, events=runner.events,
        launches_per_step=per_step, sim_bits=sim_bits,
        device_busy_share=step_prof.get("device_busy_share"),
        step_profile=dict(step_prof, top=step_prof.get("top", [])[:10]),
        train_isect_capacity=runner.isect_capacity(),
        raster_bwd_ms_by_sample=dict(min=min(bwd_ms), max=max(bwd_ms),
                                     median=float(np.median(bwd_ms))),
        slowest_view_check=check)

    # the codecs on the trained model
    ply_dir = work / "frames"
    ply_dir.mkdir()
    t1 = time.perf_counter()
    frames = runner.export_frames(np.linspace(0.0, 1.0, DYN_FRAMES))
    for i, fr in enumerate(frames):
        save_ply(str(ply_dir / f"frame_{i:04d}.ply"), fr)
    export_s = time.perf_counter() - t1
    # the frames keep the Gaussians visible at their time, so they are no
    # tracked sequence: the codec codes each frame's first side^2 rows
    frame_counts = [len(fr["means"]) for fr in frames]
    t1 = time.perf_counter()
    ladder = compress_ply_sequence.main([
        "--ply_dir", str(ply_dir), "--output_dir", str(work / "seq"),
        "--rate_points", *DYN_RATE_POINTS, "--eval_views", "3",
        "--eval_width", str(DYN_WIDTH // 2), "--eval_height",
        str(DYN_HEIGHT // 2), "--eval_frame_stride", "4", "--device",
        str(dev)])
    ladder_s = time.perf_counter() - t1
    live = {k: v.detach().cpu().numpy() for k, v in runner.splats.items()}
    t1 = time.perf_counter()
    stg_dir = work / "stg_png"
    STGPngCompression(device=dev).compress(str(stg_dir), live)
    decoded = STGPngCompression(device=dev).decompress(str(stg_dir))
    restored = {}
    for k, v in runner.splats.items():
        arr = np.zeros(tuple(v.shape), np.float32)
        dec = decoded[k].reshape((-1,) + tuple(v.shape[1:]))
        arr[:len(dec)] = dec
        if k == "opacities":
            arr[len(dec):] = DEAD_OPACITY_LOGIT
        restored[k] = torch.as_tensor(arr, device=dev)
    trained = runner.splats
    runner.splats = restored
    try:
        stg_eval = dyn_eval(runner)
    finally:
        runner.splats = trained
    stg_png = dict(bytes=compressed_size(str(stg_dir)),
                   gaussians=len(decoded["means"]), eval_decoded=stg_eval,
                   eval_trained=after, seconds=time.perf_counter() - t1)
    del runner, restored, trained

    # the committed sequence (written by the JAX package) at qp 30
    t1 = time.perf_counter()
    cframes = [load_ply(str(p_)) for p_ in
               sorted((DYN_COMMITTED / "frames").glob("*.ply"))]
    SeqCodec(backend="pngseq", qp=30).compress(str(work / "committed"),
                                               cframes)
    got = json.loads((work / "committed" / "meta.json").read_text())
    want = json.loads((DYN_COMMITTED / "seq_codec" / "rp0" / "meta.json")
                      .read_text())
    diff = seq_meta_diff(got, want)
    committed = dict(frames=len(cframes), gaussians=len(cframes[0]["means"]),
                     side=got["side"], backend=got["backend"],
                     differing_fields=diff,
                     seconds=time.perf_counter() - t1)
    if diff:
        raise AssertionError(f"the committed sequence's meta.json differs: "
                             f"{diff}")

    # the stg leg: the linear head, the omega freeze moved early
    stg = runner_for("stg", strategy="stg", color_mode="linear",
                     compression_sim=False, entropy_model_opt=False,
                     max_steps=DYN_STG_STEPS, refine_start_iter=5,
                     refine_every=10, refine_stop_iter=DYN_STG_STEPS + 1)
    stg.strategy = dataclasses.replace(stg.strategy,
                                       freeze_start_iter=DYN_STG_FREEZE)
    s_losses, s_ms, s_secs, s_launches = timed(stg, DYN_STG_STEPS)
    # read at the run's last step, a refine: a frozen omega is zeroed
    # there, and Adam's first moment moves it again on the next steps
    # (its gradient is masked, not its moments), as in the JAX package
    keep = stg.strategy_state["omega_keep"]
    frozen_nonzero = int((stg.splats["omega"][~keep] != 0).any(-1).sum())
    stg_leg = dict(steps=DYN_STG_STEPS, freeze_start_iter=DYN_STG_FREEZE,
                   loss_first5=s_losses[:5], loss_last5=s_losses[-5:],
                   step_ms_median=float(np.median(s_ms)), seconds=s_secs,
                   omega_kept=int(keep.sum()), omega_frozen=int(
                       (~keep).sum()), frozen_omegas_nonzero=frozen_nonzero,
                   densify_count_max=int(stg.strategy_state[
                       "densify_count"].max()), events=stg.events,
                   launches_per_step={k: v / DYN_STG_STEPS for k, v in
                                      s_launches.items() if v})
    if frozen_nonzero or not all(math.isfinite(v) for v in s_losses):
        raise AssertionError(f"dynamic stg leg: {stg_leg}")
    del stg

    # the mcmc leg through the command line, on an INVR directory
    t1 = time.perf_counter()
    invr = work / "invr"
    write_invr_scene(invr, samples, {1, 2, 3}, {0},
                     set(range(0, DYN_FRAMES, 4)), init_pts)
    write_s = time.perf_counter() - t1
    out = work / "cli"
    argv = ["--data-dir", str(invr), "--result-dir", str(out), "--factor",
            "1", "--max-steps", str(DYN_CLI_STEPS), "--cap-max",
            str(DYN_CAP), "--strategy", "mcmc", "--export-frames", "4",
            "--eval-video", "--eval-video-frames", "4", "--device",
            str(dev)]
    rv.reset_launch_counts()
    t1 = time.perf_counter()
    cli_runner = dyn_trainer_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    cli_launches = dict(rv.LAUNCHES)
    stats = json.loads((out / "stats.json").read_text())
    video = [p_.name for p_ in out.iterdir() if p_.name.startswith(
        "eval_view0")]
    cli = dict(argv=argv, stats=stats, seconds=cli_s,
               write_invr_seconds=write_s,
               train_samples=len(cli_runner.trainset),
               val_samples=len(cli_runner.valset),
               ply_seq=sorted(p_.name for p_ in (out / "ply_seq").iterdir()),
               eval_video=video, launches=cli_launches)
    if len(cli["ply_seq"]) != 4 or not video or not math.isfinite(
            stats["psnr"]) or min(cli_launches.get(k, 0)
                                  for k in KERNELS_3DGS) < 1:
        raise AssertionError(f"dynamic mcmc leg: {cli}")
    del cli_runner

    # the v1 leg: B7, B8 and B10 at 9 channels
    v1 = runner_for("v1", rasterizer="pallas", max_steps=DYN_V1_STEPS)
    v_losses, v_ms, v_secs, v_launches = timed(v1, DYN_V1_STEPS)
    v1_per_step = {k: v / DYN_V1_STEPS for k, v in v_launches.items() if v}
    if min(v_launches.get(k, 0) for k in KERNELS_V1 + ("cumsum_rows",)) \
            < DYN_V1_STEPS or not all(math.isfinite(v) for v in v_losses):
        raise AssertionError(f"dynamic v1 leg: {v_launches}, {v_losses}")
    with torch.no_grad():
        sp1 = {k: v.detach() for k, v in v1.splats.items()}
        v1_view = v1.order[0]
        vst = V1Stages(rp, ti, dyn_view_prep(v1, sp1, v1_view), W, H, 16,
                       rp.CUTOFF_MODE, v1.isect_capacity())
        v1_check = vst.compare(dyn_errs)
        v1_check.update(vst.compare_bwd(dyn_errs, seed=900))
        v1_check.update(channels=vst.cfg.channels, n_isects=vst.n_isects,
                        cumsum_rows=vst.scan_numbers(dyn_errs))
        del vst
    v1_leg = dict(steps=DYN_V1_STEPS, losses=v_losses,
                  step_ms_median=float(np.median(v_ms)),
                  launches_per_step=v1_per_step, view_check=v1_check)
    del v1
    shutil.rmtree(work, ignore_errors=True)
    phase = {
        "phase": "dynamic", "width": DYN_WIDTH, "height": DYN_HEIGHT,
        "views": DYN_VIEWS, "frames": DYN_FRAMES, "train_samples":
        len(train_v), "val_samples": len(val_v), "capacity": DYN_CAP,
        "channels": 9, "cuts": cuts, "scene_seconds": scene_s,
        "main": main, "stg": stg_leg, "mcmc_cli": cli, "v1": v1_leg,
        "seq_codec": dict(rows=ladder, seconds=ladder_s,
                          export_seconds=export_s, ffmpeg=have_ffmpeg(),
                          frame_gaussians=frame_counts,
                          coded_per_frame=int(math.isqrt(
                              min(frame_counts))) ** 2),
        "stg_png": stg_png, "committed_sequence": committed,
        "errors": dyn_errs, "seconds": time.perf_counter() - t0}
    rel = dict(pack_rows=0.0, expand=0.0, unpack_rows=0.0,
               raster_fwd=check["fwd_rel_err"],
               raster_bwd=check["bwd_rel_err_absgrad_0"],
               segsum_rows=check["segsum_rel_err"],
               raster_v1_bwd=v1_check["v1_bwd_rel_err"])
    return phase, per_step, v1_per_step, dyn_errs, rel


CAMERA_VIEWS = 4  # the cameras phase's orbit views, rendered as one batch
CAMERA_MODELS = ("pinhole", "ortho", "fisheye")
PROJ_TOL = 1e-4  # card vs CPU projection: each output's largest |error|
# over its largest |value|, on the rows both devices keep
PROJ_GRAD_TOL = 1e-3  # the same for the gradients (as the training tests)
PROJ_FLIP_SHARE = 1e-3  # rows whose radii round to another integer
# pinhole's general branch against its fast path (two formulas):
# the compensation sqrt(det / det_blurred) takes the rounding of det =
# ac - b^2, which cancels for elongated splats (1.04e-4 on the card)
COVARS_COMP_TOL = 1e-3


def _masked_rel_err(a, b, keep):
    """Largest |a - b| over the rows of ``keep`` ([..] of the leading
    dims), over the largest |b| there."""
    a, b = a.float(), b.float()
    while keep.dim() < a.dim():
        keep = keep[..., None]
    d = torch.where(keep, (a - b).abs(), torch.zeros_like(a))
    s = torch.where(keep, b.abs(), torch.zeros_like(b))
    return float(d.max()) / max(float(s.max()), 1e-30)


def projection_check(dev, means, quats, scales, opac, vm, K, model):
    """fully_fused_projection (elliptical radii, compensations, opacities)
    on the card against the CPU: the radii's share of rows that differ,
    each output's relative error and the gradients' of a seeded weighting
    of the outputs with respect to the means, quats and scales, on the
    rows both devices keep (a Gaussian whose radii differ in a view is
    left out of the gradients)."""
    from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection

    g = torch.Generator(device="cpu").manual_seed(31)
    C, N = vm.shape[0], means.shape[0]
    w = [torch.randn((C, N) + s, generator=g) for s in ((2,), (), (3,), ())]
    outs = {}
    for d in (dev, torch.device("cpu")):
        leaves = [t.detach().to(d).requires_grad_(True)
                  for t in (means, quats, scales)]
        out = fully_fused_projection(
            leaves[0], None, leaves[1], leaves[2], vm.to(d), K.to(d), WIDTH,
            HEIGHT, calc_compensations=True, camera_model=model,
            opacities=opac.to(d), elliptical=True)
        loss = sum((o * x.to(d)).sum() for o, x in zip(out[1:], w))
        loss.backward()
        outs[d.type] = ([o.detach().cpu() for o in out],
                        [t.grad.cpu() for t in leaves])
    (card, card_g), (cpu, cpu_g) = outs[dev.type], outs["cpu"]
    same = (card[0] == cpu[0]).all(-1)  # [C, N]
    keep = same & (cpu[0] > 0).any(-1)
    res = {"radii_differ_share": 1.0 - float(same.float().mean()),
           "visible": int(keep.sum())}
    for name, a, b in zip(("means2d", "depths", "conics", "compensations"),
                          card[1:], cpu[1:]):
        res[f"{name}_rel_err"] = _masked_rel_err(a, b, keep)
    rows = same.all(0)
    for name, a, b in zip(("means", "quats", "scales"), card_g, cpu_g):
        res[f"grad_{name}_rel_err"] = _masked_rel_err(a, b, rows)
    if not (res["radii_differ_share"] <= PROJ_FLIP_SHARE and keep.any()
            and max(v for k, v in res.items() if k.endswith("rel_err")
                    and not k.startswith("grad")) <= PROJ_TOL
            and max(v for k, v in res.items() if k.startswith("grad"))
            <= PROJ_GRAD_TOL):
        raise AssertionError(f"{model} projection on the card differs from "
                             f"the CPU: {res}")
    return res


def covars_check(means, quats, scales, opac, vm, K, model):
    """fully_fused_projection from explicit covariances
    (quat_scale_to_covar) against quats and scales: the same bits where
    both take the general branch (ortho, fisheye); for pinhole, the
    general branch against the fast path within PROJ_TOL on the rows
    whose radii agree (the compensations within COVARS_COMP_TOL)."""
    from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
    from gscodec_studio_tpu_torch.ops.quat import quat_scale_to_covar

    kw = dict(calc_compensations=True, camera_model=model, opacities=opac,
              elliptical=True)
    with torch.no_grad():
        a = fully_fused_projection(means, quat_scale_to_covar(quats, scales),
                                   None, None, vm, K, WIDTH, HEIGHT, **kw)
        b = fully_fused_projection(means, None, quats, scales, vm, K, WIDTH,
                                   HEIGHT, **kw)
    if model != "pinhole":
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{model}: explicit covars differ from "
                                 f"quats and scales in the general branch")
        return {"same_bits": True}
    same = (a[0] == b[0]).all(-1)
    keep = same & (b[0] > 0).any(-1)
    res = {"radii_differ_share": 1.0 - float(same.float().mean()),
           **{f"{n}_rel_err": _masked_rel_err(x, y, keep) for n, x, y in zip(
               ("means2d", "depths", "conics", "compensations"), a[1:],
               b[1:])}}
    if not (res["radii_differ_share"] <= PROJ_FLIP_SHARE and max(
            v for k, v in res.items() if k.endswith("rel_err")
            and not k.startswith("compensations")) <= PROJ_TOL
            and res["compensations_rel_err"] <= COVARS_COMP_TOL):
        raise AssertionError(f"pinhole covars: the general branch differs "
                             f"from the fast path: {res}")
    return res


def cameras(dev, errs, stages_for):
    """The serve checkpoint at 1297x840, tile 16, from CAMERA_VIEWS orbit
    views through each camera model: pinhole (the orbit's K), ortho (fx =
    fy = the width over the scene's extent across the view, the 1st to
    the 99th percentile of the camera-frame x) and fisheye (the orbit's
    K). For each: the intersections a view (binning's rows, against the
    capacity used, 1.2x the probe, and the default 8 a Gaussian, which
    must not truncate silently); one fwd+bwd of rasterization(rasterizer=
    "fused") of the four views with a seeded cotangent (launches of every
    kernel, median ms, device profile); B9a, B3, B1, B2, B9b and B4 on the
    batch's own inputs against their plain versions (compare,
    compare_bwd, B1's and B2's regions), each kernel's ms; one v1
    ("pallas") forward, B7 and B8 against their plain versions with their
    regions; the projection on the card against the CPU
    (projection_check) and explicit covariances against quats and scales
    (covars_check). Returns the phase dict."""
    from gscodec_studio_tpu_torch.models.splats import from_jax_splats
    from gscodec_studio_tpu_torch.ops import isect as ti
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    from gscodec_studio_tpu_torch.rendering import (_default_isect_capacity,
                                                    project_and_shade,
                                                    rasterization)
    from gscodec_studio_tpu_torch.utils.ply_render import orbit_cameras

    t0 = time.perf_counter()
    with np.load(CHECKPOINT) as z:
        splats = {k: z[k] for k in z.files}
    model = from_jax_splats(splats, device=dev)
    N = model.num_splats
    cams = orbit_cameras(splats["means"], n_views=CAMERA_VIEWS, width=WIDTH,
                         height=HEIGHT)
    C = len(cams)
    vm = torch.as_tensor(np.stack([np.linalg.inv(c["camtoworld"])
                                   for c in cams]), device=dev)
    K_pin = torch.as_tensor(np.stack([c["K"] for c in cams]), device=dev)
    with torch.no_grad():
        means, quats = model.means.detach(), model.quats.detach()
        scales = torch.exp(model.scales.detach())
        opac = torch.sigmoid(model.opacities.detach())
        colors = model.sh_coeffs().detach()
        xc = means @ vm[:, 0, :3].T + vm[:, 0, 3]  # [N, C]
        q = torch.tensor([0.01, 0.99], device=dev)
        lo, hi = torch.quantile(xc, q, dim=0)
        K_ortho = K_pin.clone()
        K_ortho[:, 0, 0] = K_ortho[:, 1, 1] = WIDTH / (hi - lo)
    Ks = {"pinhole": K_pin, "ortho": K_ortho, "fisheye": K_pin}
    TW, TH = -(-WIDTH // 16), -(-HEIGHT // 16)
    cot = torch.randn((C, HEIGHT, WIDTH, 3), generator=torch.Generator(
        device="cpu").manual_seed(17)).to(dev)
    default_cap = _default_isect_capacity(C, N)
    out = {}
    for cm in CAMERA_MODELS:
        K = Ks[cm]
        res = {"K": K[:, :3, :3].tolist()}
        with torch.no_grad():
            prep = project_and_shade(means, quats, scales, opac, colors, vm,
                                     K, WIDTH, HEIGHT, sh_degree=3,
                                     camera_model=cm)
        per_view = rv.tile_counts(prep[1], prep[0], 16, TW, TH)[3].sum(1)
        total = int(per_view.sum())
        cap = -(-int(1.2 * total + 1) // rv.CAP_BLOCK) * rv.CAP_BLOCK
        res.update(n_isects_per_view=per_view.tolist(), n_isects=total,
                   isect_capacity=cap, default_capacity=default_cap,
                   default_capacity_truncates=total >= default_cap,
                   visible_per_view=(prep[0] > 0).any(-1).sum(1).tolist())
        leaves = [t.clone().requires_grad_(True)
                  for t in (means, quats, scales, opac, colors)]

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            img, alpha, meta = rasterization(
                *leaves, vm, K, WIDTH, HEIGHT, sh_degree=3, camera_model=cm,
                isect_capacity=cap, device=dev)
            (img * cot).sum().backward()
            return img.detach(), alpha.detach(), meta

        rv.reset_launch_counts()
        img, alpha, meta = fwd_bwd()
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
        if min(launches[k] for k in KERNELS_3DGS) < 1:
            raise AssertionError(f"{cm}: a kernel did not launch: "
                                 f"{launches}")
        if int(meta["n_isects"]) != total or total >= cap:
            raise AssertionError(f"{cm}: n_isects {int(meta['n_isects'])} "
                                 f"against the probe {total}, capacity {cap}")
        if not (bool(torch.isfinite(img).all()) and all(
                bool(torch.isfinite(t.grad).all()) for t in leaves)):
            raise AssertionError(f"{cm}: non-finite pixels or gradients")
        mean_alpha = alpha.mean(dim=(1, 2, 3))
        if not float(mean_alpha.min()) > 0.05:
            raise AssertionError(f"{cm}: mean alpha {mean_alpha.tolist()}")
        res.update(launches=launches, mean_alpha=mean_alpha.tolist(),
                   fwd_bwd_ms=median_ms(fwd_bwd, 3)[0],
                   device=device_profile(fwd_bwd, reps=1))
        res["device"]["top"] = res["device"].get("top", [])[:8]

        # the kernels on the batch's own inputs
        st = stages_for(prep, WIDTH, HEIGHT, 16, "exact", cap=cap)
        check = st.compare(errs)
        check.update(st.compare_bwd(errs, seed=23, absgrads=(False,)))
        check["b2_regions"] = region_summary(b2_regions(rv, st))
        check["b1_regions"] = region_summary(b1_regions(rv, st))
        b, cfg = st.b, st.cfg
        res["check"] = check
        res["kernel_ms"] = dict(
            pack_rows=cuda_ms(lambda: rv.pack_rows(st.row_list, cfg.d_s,
                                                   b.perm), 5),
            expand=cuda_ms(lambda: rv.expand(b.cum, b.base, b.nx, b.table,
                                             b.n_isects, cfg), 5),
            raster_fwd=cuda_ms(lambda: rv.raster_fwd(
                b.S, b.starts, st.masks, cfg, order=st.runs), 5),
            raster_bwd=cuda_ms(lambda: rv.raster_bwd(
                b.S, b.starts, st.masks, st.out, st.v_tiles, cfg, False), 5),
            segsum_rows=cuda_ms(lambda: rv.segsum_rows(st.rows, b.cum,
                                                       b.n_isects), 5),
            unpack_rows=cuda_ms(lambda: rv.unpack_rows(
                st.gbuf, st.gbuf.shape[0], b.perm), 5))
        del st

        # the v1 backend: one forward, and B7 and B8 on its inputs
        with torch.no_grad():
            prep_s = project_and_shade(means, quats, scales, opac, colors, vm,
                                       K, WIDTH, HEIGHT, sh_degree=3,
                                       camera_model=cm, elliptical=False)
            rows_v1 = int(rv.tile_counts(prep_s[1], prep_s[0], 16, TW,
                                         TH)[3].sum())
            cap_v1 = int(1.2 * rows_v1) + 1
            rv.reset_launch_counts()
            img_v1, _, meta_v1 = rasterization(
                means, quats, scales, opac, colors, vm, K, WIDTH, HEIGHT,
                sh_degree=3, camera_model=cm, rasterizer="pallas",
                isect_capacity=cap_v1, device=dev)
            torch.cuda.synchronize()
        v1_launches = dict(rv.LAUNCHES)
        if v1_launches["raster_v1_fwd"] != 1 or int(
                meta_v1["n_isects"]) != rows_v1 or not bool(
                torch.isfinite(img_v1).all()):
            raise AssertionError(f"{cm} v1: launches {v1_launches}, n_isects "
                                 f"{int(meta_v1['n_isects'])} of {rows_v1}")
        v1 = V1Stages(rp, ti, prep_s, WIDTH, HEIGHT, 16, rp.CUTOFF_MODE,
                      cap_v1)
        v1_check = v1.compare(errs)
        v1_check.update(v1.compare_bwd(errs, seed=29))
        c = v1.regions()
        res["v1"] = dict(
            n_isects=rows_v1, isect_capacity=cap_v1,
            cutoff_mode=rp.CUTOFF_MODE, raster_v1_fwd_launches=1,
            mean_abs_diff_vs_fused=float((img_v1 - img).abs().mean()),
            check=v1_check, missed_slots=c["missed_slots"],
            raster_v1_fwd_ms=cuda_ms(lambda: rp.raster_v1_fwd(*v1.args,
                                                             v1.cfg), 5))
        del v1, prep_s, img_v1

        res["projection_card_vs_cpu"] = projection_check(
            dev, means, quats, scales, opac, vm, K, cm)
        res["explicit_covars"] = covars_check(means, quats, scales, opac,
                                              vm, K, cm)
        out[cm] = res
        del prep, leaves, img, alpha
    pin = out["pinhole"]
    return {
        "phase": "cameras", "checkpoint": str(CHECKPOINT.relative_to(ROOT)),
        "gaussians": N, "views": C, "width": WIDTH, "height": HEIGHT,
        "tile_size": 16, "models": out,
        "n_isects_over_pinhole": {cm: out[cm]["n_isects"] / pin["n_isects"]
                                  for cm in CAMERA_MODELS},
        "kernel_ms_over_pinhole": {cm: {
            k: v / pin["kernel_ms"][k] for k, v in out[cm][
                "kernel_ms"].items()} for cm in CAMERA_MODELS},
        "proj_tol": PROJ_TOL, "proj_grad_tol": PROJ_GRAD_TOL,
        "covars_compensation_tol": COVARS_COMP_TOL,
        "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL,
        "seconds": time.perf_counter() - t0}


def attribute_bytes(compress_dir, meta):
    """The bytes on disk of each attribute's files (its name, then "." or
    "_"), and of meta.json."""
    files = os.listdir(compress_dir)
    out = {name: sum(os.path.getsize(os.path.join(compress_dir, f))
                     for f in files if f.startswith((name + ".", name + "_")))
           for name in meta["attrs"]}
    out["meta.json"] = os.path.getsize(os.path.join(compress_dir,
                                                    "meta.json"))
    return out


def entropy_codec_run(runner, dev, kind, step):
    """run_compression(step, "entropy_coding") of a trained Runner (its
    table kind: "histogram", "factorized" or "gaussian"), with the
    forward kernels' launches of its evaluation; the stream decoded again
    on the CPU, bit for bit the card's decode; the stages' seconds, the
    grid side, size_bytes and each attribute's bytes; PSNR before and
    after; gsc_metrics of the held-out view's render (trained and decoded)
    against its target; sequence_metrics of the trained and the decoded
    splats as a pair of frames on the stand-in's first CAMERA_VIEWS orbit
    views; the same splats' bytes against histograms (for the model
    kinds); the Gaussians whose raw log scale the codec's bound clips and
    the trained PSNR with only that clip; and the
    decoded scene's held-out render timed by honest_timer."""
    from gscodec_studio_tpu_torch.compression import entropy_coding as ec
    from gscodec_studio_tpu_torch.compression_sim.simulation import BOUNDS
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.utils.gsc_metrics import gsc_metrics
    from gscodec_studio_tpu_torch.utils.ply_render import (render_splats,
                                                           sequence_metrics)
    from gscodec_studio_tpu_torch.utils.profiling import honest_timer
    from gscodec_studio_tpu_torch.models.splats import from_jax_splats

    t0 = time.perf_counter()
    models = runner.entropy_models()
    got_kind = "histogram" if models is None else (
        "gaussian" if isinstance(next(iter(models.values())), tuple)
        else "factorized")
    if got_kind != kind:
        raise AssertionError(f"entropy_codec: the runner's tables are "
                             f"{got_kind}, not {kind}")
    before = runner.eval(f"before_entropy_coding_{step}")
    trained = runner.live_splats()
    # the codec clips each coded attribute to the simulation's bounds: the
    # trained scene's PSNR with only its raw log scales clipped so
    lo_s, hi_s = BOUNDS["scales"]
    backup = runner.splats
    runner.splats = dict(backup, scales=torch.clamp(backup["scales"], lo_s,
                                                    hi_s))
    try:
        scales_clipped = runner.eval(f"scales_clipped_{step}")
    finally:
        runner.splats = backup
    card = {}
    decompress = ec.EntropyCodingCompression.decompress

    def keep_decode(self, compress_dir):
        card["decoded"] = decompress(self, compress_dir)
        return card["decoded"]

    ec.EntropyCodingCompression.decompress = keep_decode
    try:
        rv.reset_launch_counts()
        metrics = runner.run_compression(step, method="entropy_coding")
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
    finally:
        ec.EntropyCodingCompression.decompress = decompress
    if min(launches[k] for k in FWD_KERNELS) < 1:
        raise AssertionError(f"entropy_codec {kind}: the evaluation did not "
                             f"launch the forward kernels: {launches}")
    out_dir = os.path.join(runner.cfg.result_dir, f"compression_{step}")
    meta = json.loads(Path(out_dir, "meta.json").read_text())
    t1 = time.perf_counter()
    cpu = ec.EntropyCodingCompression(device="cpu").decompress(out_dir)
    cpu_decode_s = time.perf_counter() - t1
    decoded = card["decoded"]
    if sorted(cpu) != sorted(decoded) or not all(
            np.array_equal(cpu[k], decoded[k]) for k in cpu):
        raise AssertionError(f"entropy_codec {kind}: the CPU decode differs "
                             f"from the card's")
    # the same splats against histograms, for the model tables' rate
    hist_dir = out_dir + "_histogram"
    if kind != "histogram":
        ec.EntropyCodingCompression(device=dev).compress(hist_dir, trained)
    kinds = {m["kind"] for m in meta["attrs"].values()}
    want_kind = {"histogram": "ans", "factorized": "ans",
                 "gaussian": "ans_gauss"}[kind]
    if want_kind not in kinds or (kind == "factorized") != any(
            m.get("model") for m in meta["attrs"].values()):
        raise AssertionError(f"entropy_codec {kind}: stream kinds {kinds}")
    if not (math.isfinite(metrics["psnr"]) and metrics["size_bytes"] > 0
            and metrics["psnr"] > before["psnr"] - 3.0):
        raise AssertionError(f"entropy_codec {kind}: {metrics} after "
                             f"{before}")

    # the held-out view: the trained and the decoded renders' GSC metrics
    data = runner.valset[0]
    tgt = torch.as_tensor(data["image"]).float().cpu().numpy()
    h, w = tgt.shape[:2]
    backup = runner.splats
    gsc = {"trained": gsc_metrics(tgt, runner.render_view(
        data["camtoworld"], data["K"], w, h).cpu().numpy(), device=dev)}
    runner.splats = {k: torch.as_tensor(v, device=dev)
                     for k, v in decoded.items()}
    try:
        gsc["decoded"] = gsc_metrics(tgt, runner.render_view(
            data["camtoworld"], data["K"], w, h).cpu().numpy(), device=dev)
        render_s = honest_timer(lambda c: c + runner.render_view(
            data["camtoworld"], data["K"], w, h)[0, 0, 0] * 0, K=8,
            repeats=2, device=dev)
    finally:
        runner.splats = backup
    if not gsc["decoded"]["msssim_y"] > 0.5:
        raise AssertionError(f"entropy_codec {kind}: {gsc}")

    # the trained and the decoded splats as a pair of frames, from the
    # stand-in's first orbit views: orbit_cameras around the trained means
    # frames the far Gaussians of the MCMC runs (the position noise moves
    # near-transparent ones far out, ROADMAP watch-list), whose radius
    # left ~0.13M intersections a view there against ~1.6M
    def host(x):
        return torch.as_tensor(x).float().cpu().numpy()

    cams = [{"camtoworld": host(d["camtoworld"]), "K": host(d["K"]),
             "width": w, "height": h}
            for d in (runner.trainset[i] for i in range(
                min(CAMERA_VIEWS, len(runner.trainset))))]
    cap = 1 << 23
    probe = render_splats(from_jax_splats(trained, device=dev), cams,
                          isect_capacity=cap)
    n_isects = [int(m["n_isects"]) for _, _, m in probe]
    if max(n_isects) >= cap:
        raise AssertionError(f"entropy_codec {kind}: {n_isects} >= {cap}")
    seq = sequence_metrics([trained], [decoded], cams, device=dev,
                           isect_capacity=cap)
    return {
        "kind": kind, "step": step, "side": meta["side"],
        "gaussians": int(meta["side"]) ** 2,
        "stream_kinds": {k: m["kind"] for k, m in meta["attrs"].items()},
        "size_bytes": metrics["size_bytes"],
        "attribute_bytes": attribute_bytes(out_dir, meta),
        "histogram_attribute_bytes": None if kind == "histogram" else
        attribute_bytes(hist_dir, json.loads(Path(
            hist_dir, "meta.json").read_text())),
        "scales_above_bound": int((torch.as_tensor(trained["scales"])
                                   > hi_s).any(-1).sum()),
        "psnr_scales_clipped": scales_clipped["psnr"],
        "seconds": runner.compression_seconds,
        "cpu_decode_seconds": cpu_decode_s,
        "cpu_decode_same_bits": True,
        "psnr_before": before["psnr"], "psnr_after": metrics["psnr"],
        "ssim_before": before["ssim"], "ssim_after": metrics["ssim"],
        "gsc_metrics_held_out": gsc, "sequence_metrics": seq,
        "sequence_n_isects": n_isects,
        "decoded_render_ms_honest_timer": render_s * 1e3,
        "launches": {k: v for k, v in launches.items() if v},
        "phase_seconds": time.perf_counter() - t0}


# -- multigpu: the Gaussian-sharded mesh path (parallel/, the mesh Runner)

MESH_RANKS = 2  # gloo ranks, every one on the one card
MESH_VIEWS = 8  # the serve checkpoint's orbit views
MESH_ISECT = 8 << 20  # the 8 views' intersection capacity
MESH_SMALL_CAP = 4096  # a bucketed cap that the visible rows overflow
MESH_STEPS = 10  # the mesh Runner's steps; refines after steps 5 and 10
DRYRUN_GAUSS, DRYRUN_SIZE = 100_000, 256  # __graft_entry__'s dryrun shape
MESH_RTOL, MESH_ATOL = 1e-3, 2e-3  # tests/test_distributed.py:63-65
MESH_BUCKET_TOL = 1e-4  # the covering bucketed render against the dense
MESH_LOSS_RTOL = 1e-4  # the first mesh step against the single-device one
MESH_TIMEOUT = 600  # seconds for the spawned ranks, collectives included
MESH_LABEL = "gloo, 2 ranks on one card"


def mesh_scene():
    """The serve checkpoint's splat dict and its MESH_VIEWS orbit views'
    viewmats and Ks at WIDTH x HEIGHT."""
    from gscodec_studio_tpu_torch.utils.ply_render import orbit_cameras

    with np.load(CHECKPOINT) as z:
        splats = {k: np.asarray(z[k], np.float32) for k in z.files}
    cams = orbit_cameras(splats["means"], n_views=MESH_VIEWS, width=WIDTH,
                         height=HEIGHT)
    vm = np.stack([np.linalg.inv(c["camtoworld"]) for c in cams]).astype(
        np.float32)
    return splats, vm, np.stack([c["K"] for c in cams]).astype(np.float32)


def single_render(sp, vm, Ks, dev, groups=1):
    """The whole model's render on one device: (the render path's own
    pipeline, the projection with the scalar radius binned by the fused
    kernels, as distributed_render bins, its cameras in ``groups`` batches
    as the ranks split them; rendering.rasterization of all of them, which
    bins each splat's per-axis box of its opacity's reach). A camera's
    render depends on its batch under the exact cutoff: a tile's run
    starts where the batch's table puts it on the 128-row chunk grid, and
    a pixel that stops inside a chunk resumes in the next (ROADMAP
    watch-list), so the mesh is held against the same batches."""
    from gscodec_studio_tpu_torch.models.splats import splat_activations
    from gscodec_studio_tpu_torch.ops.raster_v2 import rasterize_to_pixels_v2
    from gscodec_studio_tpu_torch.rendering import (project_and_shade,
                                                    rasterization)

    with torch.no_grad():
        m, q, s, o = splat_activations(sp)
        colors = torch.cat([sp["sh0"], sp["shN"]], 1)
        vm, Ks = (torch.as_tensor(x, device=dev) for x in (vm, Ks))
        prep = project_and_shade(m, q, s, o, colors, vm, Ks, WIDTH, HEIGHT,
                                 sh_degree=3, elliptical=False)
        radii, means2d, depths, conics, cols, opac, _ = prep
        n = len(vm) // groups
        parts = [rasterize_to_pixels_v2(
            means2d[g:g + n], conics[g:g + n], cols[g:g + n], opac[g:g + n],
            depths[g:g + n], radii[g:g + n], WIDTH, HEIGHT,
            isect_capacity=MESH_ISECT, device=dev)
            for g in range(0, len(vm), n)]
        img = torch.cat([p_[0] for p_ in parts])
        img2, _, meta2 = rasterization(
            m, q, s, o, colors, vm, Ks, WIDTH, HEIGHT, sh_degree=3,
            isect_capacity=MESH_ISECT, device=dev)
    if max([int(p_[2]["n_isects"]) for p_ in parts]
           + [int(meta2["n_isects"])]) >= MESH_ISECT:
        raise AssertionError("multigpu: a reference render filled its "
                             "intersection capacity")
    return img, img2


def within(got, ref, rtol, atol):
    diff = (got - ref).abs()
    return bool((diff <= atol + rtol * ref.abs()).all()), float(diff.max())


def exchange_ms(mesh, x, reps=3):
    """The all_to_all of ``x``: CUDA-event ms and host ms, each the mean of
    ``reps`` calls after one (every rank calls it alike)."""
    mesh.all_to_all(x)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        mesh.all_to_all(x)
    e1.record()
    e1.synchronize()
    return dict(event_ms=e0.elapsed_time(e1) / reps,
                host_ms=(time.perf_counter() - t0) * 1e3 / reps,
                bytes=x.numel() * x.element_size(), shape=list(x.shape))


def stages_of(rv, prep, width, height, ts, cutoff, cap=None, **knobs):
    """Stages of project_and_shade's outputs (or of the same tensors after
    an exchange); the capacity, unless given, 1.2x the binned rows of a
    first count; ``knobs`` are V2Cfg's precision fields."""
    radii, means2d, depths, conics, colors_cn, opac_cn, _ = prep
    C, N = depths.shape
    TW, TH = -(-width // ts), -(-height // ts)
    if cap is None:
        _, _, _, cnt = rv.tile_counts(means2d, radii, ts, TW, TH)
        cap = int(1.2 * int(cnt.sum())) + 1
    cap = -(-cap // rv.CAP_BLOCK) * rv.CAP_BLOCK
    cfg = rv.V2Cfg(C=C, tile_width=TW, tile_height=TH, tile_size=ts,
                   channels=colors_cn.shape[-1], cap=cap, n=N,
                   cutoff=cutoff, **knobs)
    masks = torch.ones(cfg.n_tiles, dtype=torch.int32, device=depths.device)
    f = [x.contiguous() for x in (means2d, conics, colors_cn, opac_cn,
                                  depths)]
    return Stages(rv, cfg, *f, radii.contiguous(), masks)


def mesh_nccl(dev):
    """(a) NCCL at world size 1, in this process with a file-store group:
    distributed_render of the serve checkpoint's 8 views against the
    single-device render, and the exchange's all_to_all on NCCL."""
    import torch.distributed as dist

    from gscodec_studio_tpu_torch.parallel.distributed import (
        distributed_render, make_mesh)

    t0 = time.perf_counter()
    splats, vm, Ks = mesh_scene()
    sp = {k: torch.as_tensor(v, device=dev) for k, v in splats.items()}
    store = tempfile.mkdtemp(prefix="gsc_smoke_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = distributed_render(mesh, sp, vm, Ks, WIDTH, HEIGHT,
                                 sh_degree=3, isect_capacity=MESH_ISECT)
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t1) * 1e3
        ref, ref_ell = single_render(sp, vm, Ks, dev)
        ok, err = within(img, ref, MESH_RTOL, MESH_ATOL)
        err_ell = float((img - ref_ell).abs().max())
        if not ok:
            raise AssertionError(f"multigpu (a): the NCCL world-size-1 "
                                 f"render differs from the single-device "
                                 f"render by {err}")
        # the dense exchange's rows: means2d, depth, conic, 3 colours,
        # opacity and the radius, for every view and Gaussian
        x = torch.randn((MESH_VIEWS, len(splats["means"]), 11), device=dev)
        a2a = exchange_ms(mesh, x)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return dict(backend=backend, world_size=1, views=MESH_VIEWS,
                gaussians=len(splats["means"]), max_abs_err=err,
                max_abs_err_vs_rasterization=err_ell,
                render_ms=render_ms, all_to_all=a2a,
                note="NCCL at world size 1: the exchange is a copy",
                seconds=time.perf_counter() - t0)


def mesh_rank(rank, world, tmp, device="cuda:0"):
    """One spawned rank of the multigpu phase, on cuda:0 with the other
    ranks: (b) the sharded renders and rank 0's kernel checks on its
    exchanged rows, (c) the dryrun, (d) the mesh Runner."""
    import hashlib

    from gscodec_studio_tpu_torch.models.splats import splat_activations
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.parallel.distributed import (
        Mesh, _exchanged, distributed_render, make_mesh, rasterize_sharded,
        shard_rows)
    from gscodec_studio_tpu_torch.parallel.dryrun import dryrun_multichip
    from gscodec_studio_tpu_torch.rendering import project_and_shade
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner
    from gscodec_studio_tpu_torch.utils.scenes import checkpoint_stand_in

    sys.modules["torch.utils.tensorboard"] = None  # JSON scalars only
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    mesh = make_mesh(world, device=dev)  # gloo on the card's tensors

    # (b) distributed_render: dense, bucketed at a covering cap and at one
    # the visible rows overflow
    t0 = time.perf_counter()
    splats, vm, Ks = mesh_scene()
    loc = {k: shard_rows(mesh, torch.as_tensor(v, device=dev))
           for k, v in splats.items()}
    Nl = loc["means"].shape[0]
    if rank == 0:
        full = {k: torch.as_tensor(v, device=dev) for k, v in splats.items()}
        ref, _ = single_render(full, vm, Ks, dev, groups=world)
        ref_one, ref_ell = single_render(full, vm, Ks, dev)
        del full
    renders, b = {}, {}
    for label, cap in (("dense", None), ("covering", Nl),
                       ("small", MESH_SMALL_CAP)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = distributed_render(mesh, loc, vm, Ks, WIDTH, HEIGHT,
                                 sh_degree=3, isect_capacity=MESH_ISECT,
                                 exchange_cap=cap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        with torch.no_grad():
            m, q, s, o = splat_activations(loc)
            _, _, diag = rasterize_sharded(
                mesh, m, q, s, o, torch.cat([loc["sh0"], loc["shN"]], 1),
                torch.as_tensor(vm, device=dev),
                torch.as_tensor(Ks, device=dev), WIDTH, HEIGHT, 3,
                MESH_ISECT, exchange_cap=cap)
        b[label] = dict(exchange_cap=cap, render_ms=ms, finite=bool(
            torch.isfinite(img).all()), **{k: int(mesh.all_reduce(
                v, "max")) for k, v in diag.items()})
        renders[label] = img
    if rank == 0:
        ok, b["dense"]["max_abs_err_vs_single"] = within(
            renders["dense"], ref, MESH_RTOL, MESH_ATOL)
        # beside it (not checks): against the 8 cameras in one batch, and
        # against the per-axis boxes' binning
        b["dense"]["max_abs_err_vs_one_batch"] = float(
            (renders["dense"] - ref_one).abs().max())
        b["dense"]["max_abs_err_vs_rasterization"] = float(
            (renders["dense"] - ref_ell).abs().max())
        if not ok:
            raise AssertionError(f"multigpu (b): the dense render differs "
                                 f"from the single-device render: {b}")
        ok, b["covering"]["max_abs_err_vs_dense"] = within(
            renders["covering"], renders["dense"], 0.0, MESH_BUCKET_TOL)
        if not ok:
            raise AssertionError(f"multigpu (b): the covering bucketed "
                                 f"render differs from the dense: {b}")
        b["small"]["max_abs_err_vs_dense"] = float(
            (renders["small"] - renders["dense"]).abs().max())
    if not (b["small"]["overflow"] > 0 and b["small"]["finite"]
            and b["covering"]["overflow"] == 0):
        raise AssertionError(f"multigpu (b): bucketed diagnostics {b}")
    if rank == 0:
        del ref, ref_one, ref_ell
    del renders
    # the training path's exchange (per-axis radii, the soft cutoff) and
    # its all_to_all, timed; rank 0 holds the kernels on its first
    # camera's exchanged rows
    with torch.no_grad():
        m, q, s, o = splat_activations(loc)
        prep = project_and_shade(
            m, q, s, o, torch.cat([loc["sh0"], loc["shN"]], 1),
            torch.as_tensor(vm, device=dev), torch.as_tensor(Ks, device=dev),
            WIDTH, HEIGHT, sh_degree=3, elliptical=True)
        radii2, means2d, depths, conics, cols, opac_cn, _ = prep
        tree = [("means2d", means2d), ("depths", depths), ("conics", conics),
                ("colors", cols), ("opacities", opac_cn),
                ("radii2", radii2)]
        ex, radii_ex, _ = _exchanged(mesh, tree, radii2.amax(-1), None)
        x = torch.cat([t.reshape(MESH_VIEWS, Nl, -1).float()
                       for _, t in tree] + [radii2.amax(-1)[..., None]
                                            .float()], -1)
        b["all_to_all_dense"] = exchange_ms(mesh, x)
        xs = x[:, :min(MESH_SMALL_CAP, Nl)]
        b["all_to_all_small"] = exchange_ms(mesh, xs.contiguous())
    errs = {}
    if rank == 0:
        st = stages_of(rv, tuple(t[:1] for t in (
            ex["radii2"], ex["means2d"], ex["depths"], ex["conics"],
            ex["colors"], ex["opacities"])) + (None,), WIDTH, HEIGHT, 16,
            "soft")
        check = st.compare(errs)
        check.update(st.compare_bwd(errs, seed=21))
        b["kernel_check"] = dict(check, n_isects=int(st.b.n_isects),
                                 rows=int(ex["means2d"].shape[1]))
        del st
    del ex, radii_ex, prep, x, xs
    b["seconds"] = time.perf_counter() - t0
    out["render"] = b

    # (c) the dryrun: one full mesh trainer step at 100,000 Gaussians,
    # 256x256, MCMC with the simulation, exchange_cap 4096
    t0 = time.perf_counter()
    dry = dryrun_multichip(world, DRYRUN_GAUSS, (DRYRUN_SIZE, DRYRUN_SIZE),
                           device=dev, result_dir=os.path.join(tmp, "dryrun"))
    dry["seconds"] = time.perf_counter() - t0
    if not (math.isfinite(dry["loss"]) and dry["exchange"]["overflow"] > 0):
        raise AssertionError(f"multigpu (c): dryrun {dry}")
    out["dryrun"] = dry

    # (d) the mesh Runner on the checkpoint stand-in, against the
    # single-device Runner's first step on the same batch
    t0 = time.perf_counter()
    parser, trainset, valset = checkpoint_stand_in(
        CHECKPOINT, n_views=MESH_VIEWS, width=WIDTH, height=HEIGHT,
        device=dev)
    # a capacity that holds the single-device step's 2 views: the default
    # (1 << 20 here) truncates the stand-in's first step (ROADMAP
    # watch-list), a rank's 1 view less, and the losses would differ by that
    cfg = Config(result_dir=os.path.join(tmp, "runner"), batch_size=world,
                 max_steps=MESH_STEPS, refine_start_iter=0, refine_every=5,
                 isect_capacity=MESH_ISECT, eval_steps=(), save_steps=(),
                 tb_every=0)
    d = {}
    if rank == 0:
        single = Runner(dataclasses.replace(cfg, result_dir=os.path.join(
            tmp, "single")), parser=parser, trainset=trainset,
            valset=valset, device=dev)
        first = [single.view_order[j] for j in range(world)]
        one = single.train_step(first, 0, 0)
        if one["n_isects"] >= single.isect_capacity():
            raise AssertionError(f"multigpu (d): the single-device step "
                                 f"filled its capacity: {one}")
        d["single_first_loss"] = one["loss"]
        d["single_first_n_isects"] = one["n_isects"]
        del single
    runner = Runner(dataclasses.replace(cfg, mesh_devices=world),
                    parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    before = runner.eval("before")
    steps = []
    inner = runner.train_step
    # every collective inside a step, timed by CUDA events around the call
    # on the current stream (no synchronisation added): the all_to_alls of
    # the exchange and its reverse apart from the all_reduces and gathers
    calls = []
    plain = {k: getattr(Mesh, k) for k in ("all_to_all", "all_reduce",
                                           "all_gather")}

    def evented(kind):
        def call(self, *a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = plain[kind](self, *a, **k)
            e1.record()
            calls.append((kind, e0, e1))
            return res
        return call

    def timed(*a, **k):
        calls.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = inner(*a, **k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        comm = {}
        for kind, e0, e1 in calls:
            n, t = comm.get(kind, (0, 0.0))
            comm[kind] = (n + 1, t + e0.elapsed_time(e1))
        steps.append(dict(ms=ms, n_isects=res["n_isects"],
                          exchange=res["exchange"], collectives={
                              k: dict(calls=n, event_ms=t)
                              for k, (n, t) in comm.items()}))
        return res

    runner.train_step = timed
    for kind in plain:
        setattr(Mesh, kind, evented(kind))
    try:
        rv.reset_launch_counts()
        losses = runner.train(max_steps=MESH_STEPS, log_every=0)
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
    finally:
        for kind, fn in plain.items():
            setattr(Mesh, kind, fn)
    after = runner.eval("after")
    full = runner._gather(runner.splats)
    digest = hashlib.sha256()
    for k in sorted(full):
        digest.update(full[k].detach().cpu().numpy().tobytes())
    d.update(losses=losses, psnr_before=before["psnr"],
             psnr_after=after["psnr"], ssim_before=before["ssim"],
             ssim_after=after["ssim"], steps=steps,
             step_ms_median=float(np.median([s_["ms"] for s_ in steps])),
             all_to_all_ms_median=float(np.median([s_["collectives"].get(
                 "all_to_all", {}).get("event_ms", 0.0) for s_ in steps])),
             events=runner.events, skipped_steps=runner.skipped_steps,
             capacity=runner.cap, isect_capacity=runner.isect_capacity(),
             splats_sha256=digest.hexdigest(), launches=launches,
             seconds=time.perf_counter() - t0)
    if rank == 0:
        d["first_loss_rel_err"] = abs(losses[0] - d["single_first_loss"]) \
            / abs(d["single_first_loss"])
        if not d["first_loss_rel_err"] <= MESH_LOSS_RTOL:
            raise AssertionError(f"multigpu (d): the first mesh step's loss "
                                 f"{losses[0]} against the single-device "
                                 f"{d['single_first_loss']}")
    out["runner"] = d
    out["errs"] = errs
    return out


def multigpu(dev):
    """The multigpu phase: (a) distributed_render at world size 1 on NCCL
    in this process; then MESH_RANKS ranks spawned on gloo, every one on
    the one card (the kernels built here first): (b) distributed_render of
    the serve checkpoint's 8 views, dense against the single-device render
    (MESH_RTOL, MESH_ATOL), bucketed at a covering cap against the dense
    (MESH_BUCKET_TOL) and at MESH_SMALL_CAP, where the overflow must fire,
    with the exchange's diagnostics, bytes and all_to_all times, and rank
    0's B9a, B3, B1, B2, B9b and B4 against their plain versions on its
    exchanged rows (FWD_TOL, BWD_TOL; the raw checkpoint's gradients under
    a seeded cotangent reach ~1e5, so the relative errors are kept beside
    the absolute ones); (c) the dryrun at 100,000
    Gaussians, 256x256 (finite loss, overflow > 0); (d) the mesh Runner on
    the checkpoint stand-in, batch 2, MESH_STEPS steps with refines, its
    first loss against the single-device Runner's on the same batch
    (MESH_LOSS_RTOL), held-out PSNR before and after, every rank ending
    with the same bits of the whole model. No time here is a multi-GPU
    time: the ranks share one card. Returns (phase dict, rank 0's launches
    over the mesh Runner's steps, the kernels' largest absolute and
    relative errors on the exchanged rows)."""
    from gscodec_studio_tpu_torch.parallel import launcher

    t0 = time.perf_counter()
    nccl = mesh_nccl(dev)
    tmp = tempfile.mkdtemp(prefix="gsc_smoke_mesh_")
    try:
        t1 = time.perf_counter()
        ranks = launcher.spawn(mesh_rank, MESH_RANKS, tmp, backend="gloo",
                               timeout=MESH_TIMEOUT)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    digests = {r["runner"]["splats_sha256"] for r in ranks}
    if len(digests) != 1:
        raise AssertionError(f"multigpu (d): the ranks' models differ after "
                             f"the refines: {digests}")
    if len({tuple(r["runner"]["losses"]) for r in ranks}) != 1:
        raise AssertionError("multigpu (d): the ranks' losses differ")
    d = r0["runner"]
    if not (all(math.isfinite(x) for x in d["losses"])
            and d["psnr_after"] > d["psnr_before"]
            and d["skipped_steps"] == 0):
        raise AssertionError(f"multigpu (d): {d['losses']}, PSNR "
                             f"{d['psnr_before']} -> {d['psnr_after']}")
    if min(d["launches"].get(k, 0) for k in KERNELS_3DGS) < MESH_STEPS:
        raise AssertionError(f"multigpu (d): the mesh steps did not launch "
                             f"every kernel of the path: {d['launches']}")
    phase = {"phase": "multigpu", "label": MESH_LABEL,
             "transport": "gloo-direct", "nccl_world_1": nccl,
             "render": r0["render"], "render_rank1": {
                 k: v for k, v in ranks[1]["render"].items()
                 if k.startswith("all_to_all")},
             "dryrun": r0["dryrun"], "runner": d,
             "runner_rank1_step_ms": [s_["ms"] for s_ in
                                      ranks[1]["runner"]["steps"]],
             "spawn_seconds": spawn_s,
             "seconds": time.perf_counter() - t0}
    kc = r0["render"]["kernel_check"]
    rel = dict(pack_rows=0.0, expand=0.0, unpack_rows=0.0,
               raster_fwd=kc["fwd_rel_err"],
               raster_bwd=kc["bwd_rel_err_absgrad_0"],
               segsum_rows=kc["segsum_rel_err"])
    return phase, d["launches"], r0["errs"], rel


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
        # B1's and B2's tile order, made once a binning as the path makes
        # it (raster_v2.run_order): B1 is timed without the argsort
        self.runs = rv.run_order(self.b.starts, cfg)
        self.out = rv.raster_fwd(self.b.S, self.b.starts, masks, cfg,
                                 order=self.runs)

    def compare(self, errs):
        """Hold each kernel's output against its plain version on the same
        inputs. Pack must match bit for bit; expansion too, except pairs on
        the ellipse-cull bound, which are counted; forward within FWD_TOL,
        and the same bits twice."""
        rv, cfg = self.rv, self.cfg
        res = {}
        b = self.b
        table_p = rv._pack_rows_plain(self.attr_rows, cfg.n_attr_eff,
                                      b.order)
        S_p = rv._pack_rows_plain(self.row_list, cfg.d_s, b.perm)
        # packed rows hold words (some read as NaN): compare the bits
        if not (torch.equal(table_p, b.table) and torch.equal(
                S_p.view(torch.int32), b.S.view(torch.int32))):
            raise AssertionError("pack_rows kernel differs from its plain "
                                 "version")
        errs["pack_rows"] = max(errs.get("pack_rows", 0.0), 0.0)

        tile_p, rows_p = rv._expand_plain(b.cum, b.base, b.nx,
                                          b.table, b.n_isects, cfg)
        if not torch.equal(rows_p.view(torch.int32), b.rows.view(torch.int32)):
            raise AssertionError("expand kernel rows differ from plain")
        diff = (tile_p != b.tile).nonzero().squeeze(1)
        n_bound = 0
        if diff.numel():
            # a flip is allowed only between a tile and the overflow tile,
            # for a pair whose cull sides agree to float rounding
            lo = torch.minimum(b.tile[diff], tile_p[diff])
            hi = torch.maximum(b.tile[diff], tile_p[diff])
            g = b.rows[cfg.idrow, diff].to(torch.int64)
            lhs, rhs = rv._cull_lhs_rhs(cfg, lo, b.table, g)
            on_bound = (lhs - rhs).abs() <= 1e-5 * torch.clamp(rhs.abs(),
                                                                 min=1.0)
            if not bool(((hi == cfg.n_tiles) & (lo < cfg.n_tiles)
                         & on_bound).all()):
                raise AssertionError(
                    f"expand kernel keys differ off the cull bound at "
                    f"{diff.numel()} rows")
            n_bound = int(diff.numel())
        note_err(errs, rv.launch_keys("expand", [(
            cfg.geom_packed or cfg.attr_packed, "_packed")]), 0.0)
        res["cull_bound_pairs"] = n_bound

        ref, self.pair_counts = rv._fwd_plain(b.S, b.starts, self.masks,
                                              cfg, with_counts=True)
        err = float((ref - self.out).abs().max())
        if not (math.isfinite(err) and err <= FWD_TOL):
            raise AssertionError(f"raster_fwd max abs err {err} > {FWD_TOL}")
        if not torch.equal(self.out, rv.raster_fwd(
                b.S, b.starts, self.masks, cfg, order=self.runs)):
            raise AssertionError("raster_fwd differs between two runs")
        note_err(errs, rv.launch_keys("raster_fwd", rv._input_branches(cfg)),
                 err)
        res["fwd_max_abs_err"] = err
        # each output channel's largest error over its largest |value|
        # (depth and transmittance differ in scale from the colours)
        res["fwd_rel_err"] = float(
            ((ref - self.out).abs().amax(dim=(0, 1))
             / ref.abs().amax(dim=(0, 1)).clamp(min=1e-30)).max())
        return res

    def cotangent(self, seed):
        """A seeded standard-normal cotangent of the tile outputs."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        self.v_tiles = torch.randn(self.out.shape, generator=g).to(
            self.out.device)

    def compare_bwd(self, errs, seed=0, absgrads=(False, True)):
        """The backward kernels against their plain versions on a seeded
        cotangent of the tile outputs: raster_bwd with absgrad off and on
        (BWD_TOL of each row's largest |value|), unpack_rows bit for bit,
        segsum_rows within segsum_rows_bound of each sum; each kernel run
        twice gives the same bits. ``errs`` takes the largest absolute
        errors, the result both kinds. Keeps the absgrad-off inputs for
        timing."""
        rv, cfg, b = self.rv, self.cfg, self.b
        self.cotangent(seed)
        res = {}
        keys = rv.launch_keys("raster_bwd", rv._input_branches(cfg))
        for absgrad in absgrads:
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
            note_err(errs, keys, abs_err)
            res[f"bwd_rel_err_absgrad_{int(absgrad)}"] = err
            res[f"bwd_max_abs_err_absgrad_{int(absgrad)}"] = abs_err
            if not absgrad:
                self.gbuf = gbuf
        self.rows, self.seg, red = check_reduction(rv, self.gbuf, b, errs)
        res.update({"segsum_" + k: v for k, v in red.items()})
        res.update(self.compare_packed(errs, absgrads))
        return res

    def compare_packed(self, errs, absgrads=(False, True)):
        """The packed-pair branches against their plain versions on
        compare_bwd's cotangent: raster_bwd(packed=True) is the f32
        branch's output truncated, bit for bit, and each half lies within
        BF16_STEP of its value plus BWD_TOL of its row's scale from the plain
        version's half (absgrad off and on), the share of bit-equal words
        reported; the unpack moves the words bit for bit; the packed
        segment sums lie within segsum_rows_bound of each sum; each kernel
        twice gives the same bits. Keeps the absgrad-off inputs for
        timing."""
        rv, cfg, b = self.rv, self.cfg, self.b
        res = {}
        for absgrad in absgrads:
            args = (b.S, b.starts, self.masks, self.out, self.v_tiles, cfg,
                    absgrad)
            gp = rv.raster_bwd(*args, packed=True)
            if not torch.equal(gp, rv._pack_grad_rows(
                    rv.raster_bwd(*args), cfg.n_attr_eff, absgrad)):
                raise AssertionError("raster_bwd packed branch is not the "
                                     "f32 branch truncated")
            if not torch.equal(gp, rv.raster_bwd(*args, packed=True)):
                raise AssertionError("raster_bwd packed differs between two "
                                     "runs")
            ref = rv._bwd_packed_plain(*args)
            h = torch.cat(rv.unpack_pairs(gp))
            hr = torch.cat(rv.unpack_pairs(ref))
            scale = hr.abs().amax(dim=1, keepdim=True)
            diff = (h - hr).abs()
            tol = BF16_STEP * hr.abs() + BWD_TOL * (1 + BF16_STEP) * scale
            if not bool((diff <= tol).all()):
                raise AssertionError("raster_bwd packed halves differ from "
                                     "plain by more than a bf16 step")
            abs_err = float(diff.max())
            errs["raster_bwd_packed"] = max(
                errs.get("raster_bwd_packed", 0.0), abs_err)
            res[f"packed_bit_equal_share_absgrad_{int(absgrad)}"] = float(
                (gp == ref).float().mean())
            res[f"packed_max_abs_err_absgrad_{int(absgrad)}"] = abs_err
            if not absgrad:
                self.gpk = gp
        self.prows, self.pseg, red = check_reduction(rv, self.gpk, b, errs)
        res.update({"segsum_packed_" + k: v for k, v in red.items()})
        return res


def check_reduction(rv, gbuf, b, errs):
    """The backward's gradient reduction (raster_v2._reduce_grads' three
    launches) on gradient rows ``gbuf`` (f32, or packed pairs) in S's
    column order: B9b through ``perm`` against its plain version bit for
    bit, B4 within segsum_rows_bound of its plain version, B9b through
    ``order`` on the sums bit for bit, and each of the three launches
    again for the same bits. ``errs`` takes B4's largest absolute error;
    returns the expansion-order rows, the sums and B4's errors (largest
    |error| over its row's largest |sum|, largest |error|, largest share
    of the bound)."""
    d = gbuf.shape[0]
    key = "segsum_rows_packed" if gbuf.dtype == torch.int32 else \
        "segsum_rows"
    rows = rv.unpack_rows(gbuf, d, b.perm)
    if not (torch.equal(rows, rv._unpack_rows_plain(gbuf, d, b.perm))
            and torch.equal(rows, rv.unpack_rows(gbuf, d, b.perm))):
        raise AssertionError(f"unpack_rows of {gbuf.dtype} rows differs from "
                             f"its plain version or between two runs")
    seg = rv.segsum_rows(rows, b.cum, b.n_isects)
    err, abs_err, share = check_segsum(
        rv, seg, rv._segsum_plain(rows, b.cum, b.n_isects), rows, b, key)
    if not torch.equal(seg, rv.segsum_rows(rows, b.cum, b.n_isects)):
        raise AssertionError(f"{key} differs between two runs")
    out = rv.unpack_rows(seg, seg.shape[0], b.order)
    if not (torch.equal(out, rv._unpack_rows_plain(seg, seg.shape[0],
                                                   b.order))
            and torch.equal(out, rv.unpack_rows(seg, seg.shape[0],
                                                b.order))):
        raise AssertionError("unpack_rows of the sums through the depth "
                             "order differs from its plain version or "
                             "between two runs")
    note_err(errs, ["unpack_rows"], 0.0)
    note_err(errs, [key], abs_err)
    return rows, seg, dict(rel_err=err, max_abs_err=abs_err,
                           bound_share=share)


def segsum_numbers(st, packed=False):
    """B4's time (B4p's with ``packed``) on a Stages' expansion-order rows
    (after its compare_bwd), its plain version's, the library's (zeros and
    index_add_ of the rows, or of their unpacked halves) and its bound:
    the rows' first n_isects columns read, the count prefix read, the sums
    written; and its device profile (the two passes' times apart)."""
    rv, b = st.rv, st.b
    rows = st.prows if packed else st.rows
    n, M = int(b.n_isects), b.cum.shape[0]
    d_out = (2 if packed else 1) * rows.shape[0]
    ids = rv.segment_ids(b.cum, b.n_isects)
    vals = torch.cat(rv.unpack_pairs(rows[:, :n])) if packed else \
        rows[:, :n]
    return bound(dict(
        profile=device_profile(lambda: rv.segsum_rows(rows, b.cum,
                                                      b.n_isects), 5),
        ms=cuda_ms(lambda: rv.segsum_rows(rows, b.cum, b.n_isects), 10),
        plain_ms=cuda_ms(lambda: rv._segsum_plain(rows, b.cum, b.n_isects),
                         3),
        library_ms=cuda_ms(lambda: torch.zeros(
            (d_out, M), device=rows.device).index_add_(1, ids, vals), 10),
        bytes=4 * rows.shape[0] * n + 4 * M + 4 * d_out * M,
        ops=d_out * n))


def unpack_numbers(st):
    """B9b's two launches on a Stages' f32 gradient rows (after its
    compare_bwd), each with its time, its plain version's, index_copy_'s
    and its bound (the rows read, the int64 index read, the rows written):
    through ``perm`` on the [d, cap] rows in S's order, and, under
    ``per_gaussian``, through ``order`` on the [d, M] sums. Beside them
    ``row_sweep``: the first launch at 1, 2, 3, 9 and 19 rows (as many as
    there are) through ``perm`` and through torch.arange's identity, a
    coalesced gather of the same words; ``group_sweep``: the first launch
    with its rows gathered 1, 2, 3, 4 and all at a time, beside the group
    that raster_v2.unpack_row_group gives each launch."""
    rv, b = st.rv, st.b

    def launch(src, idx):
        d, L = src.shape[0], idx.shape[0]
        return bound(dict(
            ms=cuda_ms(lambda: rv.unpack_rows(src, d, idx), 10),
            plain_ms=cuda_ms(lambda: rv._unpack_rows_plain(src, d, idx), 10),
            library_ms=cuda_ms(lambda: torch.empty_like(src).index_copy_(
                1, idx, src), 10),
            bytes=(8 * d + 8) * L, ops=0, rows=d, columns=L))

    ident = torch.arange(b.perm.shape[0], device=b.perm.device)
    sweep = []
    for n in UNPACK_SWEEP_ROWS:
        if n <= st.gbuf.shape[0]:
            perm_ms = cuda_ms(lambda: rv.unpack_rows(st.gbuf, n, b.perm), 10)
            ident_ms = cuda_ms(lambda: rv.unpack_rows(st.gbuf, n, ident), 10)
            sweep.append(dict(rows=n, perm_ms=perm_ms, identity_ms=ident_ms,
                              perm_over_identity=perm_ms / ident_ms))
    d = st.gbuf.shape[0]
    groups = [dict(group=g, ms=cuda_ms(lambda: rv.unpack_rows(
        st.gbuf, d, b.perm, group=g), 10)) for g in UNPACK_GROUPS + (d,)
        if g <= d]
    return dict(launch(st.gbuf, b.perm), per_gaussian=launch(st.seg, b.order),
                row_sweep=sweep, group_sweep=groups,
                group=rv.unpack_row_group(st.gbuf.shape[1], d),
                per_gaussian_group=rv.unpack_row_group(st.seg.shape[1], d))


def check_segsum(rv, seg, ref, rows, b, what):
    """segsum_rows' output ``seg`` against its plain version's ``ref``
    within raster_v2.segsum_rows_bound; (largest |error| over each row's
    largest |sum|, largest |error|, largest share of the bound used)."""
    diff = (seg - ref).abs()
    bnd = rv.segsum_rows_bound(rows, b.cum, b.n_isects)
    if not bool((diff.double() <= bnd).all()):
        raise AssertionError(f"{what} differs from its plain version by more "
                             "than the f32 summation-order bound")
    rel = float((diff / ref.abs().amax(dim=1, keepdim=True).clamp(
        min=1e-30)).max())
    share = float((diff.double() / bnd.clamp(min=1e-300)).max())
    return rel, float(diff.max()), share


def channel_err(out, ref):
    """Largest |out - ref| over each output channel's scale, max(1, its
    largest |ref|): the depth, distortion and median channels are in scene
    units, the colours and alpha in [0, 1]."""
    d = (out - ref).abs().amax(dim=(0, 1))
    scale = ref.abs().amax(dim=(0, 1)).clamp(min=1.0)
    return float((d / scale).max())


class Stages2DGS:
    """One 2DGS binning + forward pass (the fused backend of
    rendering.rasterization_2dgs), keeping each kernel's inputs and outputs
    so each can be re-run, timed and compared."""

    def __init__(self, rv, r2, cfg, zch, means2d, transforms, colors,
                 opacities, depths, radii, masks):
        self.rv, self.r2, self.cfg, self.zch = rv, r2, cfg, zch
        self.masks = masks
        self.b = r2._build_sorted_2dgs(cfg, means2d, transforms, colors,
                                       opacities, depths, radii)
        self.attr_rows = r2._attr_rows_2dgs(cfg, means2d, transforms,
                                            colors, opacities)
        self.out = r2.raster_fwd_2dgs(self.b.S, self.b.starts, masks, cfg,
                                      zch)

    def compare(self, errs):
        """Pack and the no-cull expansion bit for bit against their plain
        versions; B5 within FWD_TOL of each output channel's scale
        (channel_err): the median and the cutoff decide alike, since T has
        the same bits in both (the plain version walks the pairs in
        order); B5 twice gives the same bits."""
        rv, r2, cfg, b = self.rv, self.r2, self.cfg, self.b
        table_p = rv._pack_rows_plain(self.attr_rows, cfg.n_attr_eff,
                                      b.order)
        S_p = rv._pack_rows_plain(list(b.rows), cfg.d_s, b.perm)
        if not (torch.equal(table_p, b.table) and torch.equal(S_p, b.S)):
            raise AssertionError("pack_rows kernel differs from its plain "
                                 "version (2DGS layout)")
        tile_p, rows_p = rv._expand_plain(b.cum, b.base, b.nx, b.table,
                                          b.n_isects, cfg)
        if not (torch.equal(tile_p, b.tile) and torch.equal(rows_p, b.rows)):
            raise AssertionError("expand kernel (cull=False) differs from "
                                 "its plain version")
        n = int(b.n_isects)
        if int((b.tile[:n] == cfg.n_tiles).sum()):
            raise AssertionError("a no-cull pair reached the overflow tile")
        errs["pack_rows"] = max(errs.get("pack_rows", 0.0), 0.0)
        errs["expand"] = max(errs.get("expand", 0.0), 0.0)
        ref, self.pair_counts = r2._fwd_2dgs_plain(
            b.S, b.starts, self.masks, cfg, self.zch, with_counts=True)
        err = channel_err(self.out, ref)
        if not (math.isfinite(err) and err <= FWD_TOL):
            raise AssertionError(f"raster_fwd_2dgs err {err} > {FWD_TOL}")
        if not torch.equal(self.out, r2.raster_fwd_2dgs(
                b.S, b.starts, self.masks, cfg, self.zch)):
            raise AssertionError("raster_fwd_2dgs differs between two runs")
        abs_err = float((self.out - ref).abs().max())
        note_err(errs, rv.launch_keys(
            "raster_fwd_2dgs", [(cfg.log_composite, "_log")]), abs_err)
        median_equal = bool(torch.equal(self.out[..., -1], ref[..., -1]))
        return {"fwd2_err": err, "fwd2_max_abs_err": abs_err,
                "median_bits_equal": median_equal}

    def compare_bwd(self, errs, seed=0):
        """B6 against its plain version on a seeded cotangent of the tile
        outputs (BWD_TOL of each row's largest |value|), twice for the same
        bits, then the gradient reduction on its rows (check_reduction).
        Keeps the inputs for timing."""
        rv, r2, cfg, b = self.rv, self.r2, self.cfg, self.b
        g = torch.Generator(device="cpu").manual_seed(seed)
        self.v_tiles = torch.randn(self.out.shape, generator=g).to(
            self.out.device)
        self.bwd_args = (b.S, b.starts, self.masks, self.out, self.v_tiles,
                         cfg, self.zch)
        gbuf = r2.raster_bwd_2dgs(*self.bwd_args)
        ref = r2._bwd_2dgs_plain(*self.bwd_args)
        diff = (gbuf - ref).abs()
        scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        err = float((diff / scale).max())
        if not (math.isfinite(err) and err <= BWD_TOL):
            raise AssertionError(f"raster_bwd_2dgs rel err {err} > "
                                 f"{BWD_TOL}")
        if not torch.equal(gbuf, r2.raster_bwd_2dgs(*self.bwd_args)):
            raise AssertionError("raster_bwd_2dgs differs between two runs")
        abs_err = float(diff.max())
        note_err(errs, rv.launch_keys("raster_bwd_2dgs",
                                      r2.bwd_branches(cfg)), abs_err)
        self.gbuf = gbuf
        self.rows, self.seg, red = check_reduction(rv, gbuf, b, errs)
        return {"bwd2_rel_err": err, "bwd2_max_abs_err": abs_err,
                **{"segsum_" + k: v for k, v in red.items()}}

    def kernel_numbers(self, cuda_ms):
        """B5's and B6's time, plain time and bound (tile_bound) at these
        inputs (B6 on compare_bwd's cotangent), under their branch's keys
        (B6's absgrad rows under "_absgrad" alone)."""
        cfg, b, r2 = self.cfg, self.b, self.r2
        sfx = "_log" if cfg.log_composite else ""
        bsfx = "_absgrad" if cfg.absgrad else sfx
        CB, P, L = cfg.channels, cfg.pixels, cfg.cap
        n_rows = int(b.starts[cfg.n_tiles] - b.starts[0])
        pc = self.pair_counts
        fwd_args = (b.S, b.starts, self.masks, cfg, self.zch)
        table_bytes = (4 * (12 + CB) * n_rows + 4 * (cfg.n_tiles_v + 1)
                       + 4 * cfg.n_tiles)
        tile_bytes = 4 * cfg.n_tiles * P * cfg.chp
        d_g = cfg.d_g(cfg.absgrad)
        tested = tested_ops(cfg) * pc["tested"]
        k = {}
        k["raster_fwd_2dgs" + sfx] = tile_bound(dict(
            ms=cuda_ms(lambda: r2.raster_fwd_2dgs(*fwd_args), 10),
            plain_ms=cuda_ms(lambda: r2._fwd_2dgs_plain(*fwd_args), 1),
            library_ms=None, bytes=table_bytes + tile_bytes,
            pair_counts=pc), pc, b5_regions(r2, self)["candidate_slots"],
            FWD2_OPS_EVALUATED,
            tested + (FWD2_OPS_COMPOSITED + 2 * CB) * pc["composited"])
        n_uv = pc["composited_uv"]
        n_filter = pc["composited"] - n_uv
        k["raster_bwd_2dgs" + bsfx] = tile_bound(dict(
            ms=cuda_ms(lambda: r2.raster_bwd_2dgs(*self.bwd_args), 5),
            plain_ms=cuda_ms(lambda: r2._bwd_2dgs_plain(*self.bwd_args), 1),
            library_ms=None,
            bytes=table_bytes + 2 * tile_bytes + 4 * d_g * L,
            pair_counts=pc), pc, b6_regions(r2, self)["candidate_slots"],
            FWD2_OPS_EVALUATED,
            tested + (BWD2_OPS_COMPOSITED + 3 * CB + d_g) * pc["composited"]
            + BWD2_OPS_UV * n_uv
            + (BWD2_OPS_FILTER + (BWD2_OPS_ABS if cfg.absgrad else 0))
            * n_filter)
        return k


class V1Stages:
    """The legacy v1 path's binning and forward (ops/isect.py,
    ops/rasterize_pallas.py) on project_and_shade's outputs with scalar
    radii, keeping B7's and B8's inputs and outputs so each can be re-run,
    timed and compared. ``channels`` replaces the colours by that many
    seeded uniform channels."""

    def __init__(self, rp, ti, prep, width, height, ts, cutoff, cap,
                 channels=None):
        radii, means2d, depths, conics, colors, opac = prep[:6]
        C, N = depths.shape
        if channels is not None:
            g = torch.Generator(device="cpu").manual_seed(channels)
            colors = torch.rand((C, N, channels), generator=g).to(
                means2d.device)
        CH = colors.shape[-1]
        TW, TH = -(-width // ts), -(-height // ts)
        self.rp = rp
        self.isect = ti.isect_tiles(means2d, radii, depths, ts, TW, TH, cap)
        self.al = ti.align_isects(self.isect, C, TW, TH, rp.K_CHUNK,
                                  need_inv_perm=False)
        self.cfg = rp.RasterCfg(C=C, tile_width=TW, tile_height=TH,
                                tile_size=ts, channels=CH, cap=cap,
                                cap2=self.al.ids.shape[0], m=C * N,
                                cutoff=cutoff)
        flat = torch.cat([means2d.reshape(-1, 2), conics.reshape(-1, 3),
                          opac.reshape(-1, 1), colors.reshape(-1, CH)], -1)
        self.packed = rp._pack(flat.contiguous(), self.al.ids)
        self.args = (self.packed, self.al.starts, self.al.ends)
        self.colors, self.alphas = rp.raster_v1_fwd(*self.args, self.cfg)
        self.n_isects = int(self.isect.n_isects)
        self.chunks_in_runs = int(torch.div(
            self.al.ends - self.al.starts + rp.K_CHUNK - 1, rp.K_CHUNK,
            rounding_mode="floor").sum())

    def compare(self, errs):
        """B7 against its plain version within FWD_TOL, and twice (and in
        the longest-run-first tile order) for the same bits; keeps the
        plain walk's pair counts."""
        rp = self.rp
        c, a, self.pair_counts = rp._fwd_plain(*self.args, self.cfg,
                                               with_counts=True)
        err = max(float((c - self.colors).abs().max()),
                  float((a - self.alphas).abs().max()))
        if not (math.isfinite(err) and err <= FWD_TOL):
            raise AssertionError(f"raster_v1_fwd max abs err {err} > "
                                 f"{FWD_TOL}")
        order = rp.run_order(self.al.starts, self.al.ends)
        for again in (rp.raster_v1_fwd(*self.args, self.cfg),
                      rp.raster_v1_fwd(*self.args, self.cfg, order=order)):
            if not (torch.equal(again[0], self.colors)
                    and torch.equal(again[1], self.alphas)):
                raise AssertionError("raster_v1_fwd differs between two "
                                     "runs or tile orders")
        note_err(errs, ["raster_v1_fwd"], err)
        return {"v1_fwd_max_abs_err": err}

    def cotangent(self, seed):
        """Seeded standard-normal cotangents of B7's outputs: B8's
        arguments and its plain version's."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        dev = self.colors.device
        v_colors = torch.randn(self.colors.shape, generator=g).to(dev)
        v_alphas = torch.randn(self.alphas.shape, generator=g).to(dev)
        self.bwd_args = (*self.args, self.colors, self.alphas, v_colors,
                         v_alphas, self.cfg)
        q0 = (self.colors * v_colors).sum(1, keepdim=True)
        self.plain_bwd_args = (*self.args, v_colors, v_alphas, self.alphas,
                               q0, self.cfg)

    def compare_bwd(self, errs, seed):
        """B8 against its plain version on a seeded cotangent within
        BWD_TOL of each gradient column's largest |value|, and twice (and
        in the longest-run-first tile order) for the same bits; keeps its
        output for timing."""
        rp = self.rp
        self.cotangent(seed)
        out = rp.raster_v1_bwd(*self.bwd_args)
        ref = rp._bwd_plain(*self.plain_bwd_args)
        diff = (out - ref).abs()
        err = float((diff / ref.abs().amax(0).clamp(min=1e-30)).max())
        if not (math.isfinite(err) and err <= BWD_TOL):
            raise AssertionError(f"raster_v1_bwd rel err {err} > {BWD_TOL}")
        order = rp.run_order(self.al.starts, self.al.ends)
        if not (torch.equal(out, rp.raster_v1_bwd(*self.bwd_args))
                and torch.equal(out, rp.raster_v1_bwd(*self.bwd_args,
                                                      order=order))):
            raise AssertionError("raster_v1_bwd differs between two runs "
                                 "or tile orders")
        note_err(errs, ["raster_v1_bwd"], float(diff.max()))
        self.v_packed = out
        return {"v1_bwd_rel_err": err, "v1_bwd_max_abs_err": float(
            diff.max())}

    def regions(self):
        """B7's and B8's work on these inputs (rp._region_counts, in their
        layout): raises if a slot that passes the alpha test lies outside
        its pair's candidate region; kept as self.counts."""
        c = getattr(self, "counts", None)
        if c is None:
            c = self.rp._region_counts(*self.args, self.cfg)
            if c["missed_slots"]:
                raise AssertionError(f"{c['missed_slots']} passing (pair, "
                                     f"pixel) slots outside B7's and B8's "
                                     f"candidate regions")
            self.counts = c
        return c

    def longest_tile_ms(self, fwd):
        """B7 (``fwd``) or B8 on the tile of the longest walk alone (every
        other tile's run made empty): the floor that one block per tile
        puts under the launch."""
        rp, c = self.rp, self.regions()
        ends1 = self.al.starts.clone()
        t = c["longest_tile"]
        ends1[t] = self.al.ends[t]
        args = (self.packed, self.al.starts, ends1)
        if fwd:
            return cuda_ms(lambda: rp.raster_v1_fwd(*args, self.cfg), 5)
        return cuda_ms(lambda: rp.raster_v1_bwd(*args, *self.bwd_args[3:]),
                       5)

    def work(self, ptxas=None, tail=False):
        """b7_work and b8_work: the counts of regions() (the per-tile
        distribution of the rows walked, the pairs and the (pair, pixel)
        slots composited as max, p99 and mean; the slots walked, the
        candidate ones, those tested and composited; the (pair, warp)
        walked, whose cell meets the box, with a candidate, the hits and the
        single-lane ones), each kernel's build and, with ``ptxas``
        (v1_instances of B7 and B8), its registers and spills; with
        ``tail``, each kernel on the longest tile alone."""
        from gscodec_studio_tpu_torch.ops import raster_v2 as rv

        cfg = self.cfg
        c = self.regions()

        def dist(x):
            x = x.double()
            return dict(max=int(x.max()), p99=float(torch.quantile(x, 0.99)),
                        mean=float(x.mean()))

        shared = dict(per_tile={k: dist(c[k]) for k in ("run", "pairs",
                                                        "slots")},
                      **{k: v for k, v in c.items()
                         if not isinstance(v, torch.Tensor)})
        res = {}
        # B7's and B8's builds are B1's and B2's (without the dense build)
        for name, build, fwd in (
                ("b7_work", rv.fwd_build(cfg.channels, cfg.tile_size), True),
                ("b8_work", rv.bwd_build(cfg.channels, cfg.tile_size),
                 False)):
            w = dict(build=build)
            if ptxas is not None:
                w["ptxas"] = [e for e in ptxas[name]
                              if all(e[k] == build[k] for k in (
                                  "chm", "ppt", "max_threads", "min_blocks"))
                              and e["soft"] == (cfg.cutoff == "soft")]
            if tail:
                w["longest_tile_ms"] = self.longest_tile_ms(fwd)
            res[name] = w
        res["b7_work"].update(shared)
        return res

    def order_numbers(self):
        """B7 and B8 in index order and longest run first, and the argsort
        that makes the order (rp.run_order)."""
        rp, cfg = self.rp, self.cfg
        st, en = self.al.starts, self.al.ends
        order = rp.run_order(st, en)
        return dict(
            argsort_ms=cuda_ms(lambda: rp.run_order(st, en), 10),
            fwd_index_ms=cuda_ms(lambda: rp.raster_v1_fwd(*self.args, cfg),
                                 10),
            fwd_ordered_ms=cuda_ms(lambda: rp.raster_v1_fwd(
                *self.args, cfg, order=order), 10),
            bwd_index_ms=cuda_ms(lambda: rp.raster_v1_bwd(*self.bwd_args),
                                 10),
            bwd_ordered_ms=cuda_ms(lambda: rp.raster_v1_bwd(
                *self.bwd_args, order=order), 10))

    def sorted_cols(self):
        """The "sort" reduction's table as segment_reduce makes it: B8's
        rows sorted by Gaussian id (stable), transposed to [D, cap2]."""
        ids = torch.where(self.al.ids >= 0, self.al.ids, self.cfg.m).long()
        rows = self.v_packed[torch.sort(ids, stable=True).indices]
        return rows.t().contiguous()

    def scan_numbers(self, errs):
        """B10 on the "sort" reduction's own [D, cap2] table: within
        rv.cumsum_rows_bound of a float64 cumsum and the same bits twice
        (raises otherwise; its error goes into errs); its time beside
        torch.cumsum's and its bound."""
        from gscodec_studio_tpu_torch.ops import raster_v2 as rv

        cols = self.sorted_cols()
        out = rv.cumsum_rows(cols)
        diff = (out.double() - torch.cumsum(cols.double(), 1)).abs()
        cbound = rv.cumsum_rows_bound(cols)
        if not bool((diff <= cbound).all()):
            raise AssertionError("cumsum_rows differs from the float64 "
                                 "cumsum by more than its bound on the v1 "
                                 "reduction's table")
        if not torch.equal(out, rv.cumsum_rows(cols)):
            raise AssertionError("cumsum_rows differs between two runs on "
                                 "the v1 reduction's table")
        R, L = cols.shape
        note_err(errs, ["cumsum_rows"], float(diff.max()))
        res = bound(dict(
            shape=[R, L], max_abs_err=float(diff.max()),
            bound_share=float((diff / cbound.clamp(min=1e-300)).max()),
            ms=cuda_ms(lambda: rv.cumsum_rows(cols), 10),
            torch_cumsum_ms=cuda_ms(lambda: torch.cumsum(cols, 1), 10),
            bytes=8 * R * L, ops=R * L))
        del cols, out, diff, cbound
        return res

    def sort_cancellation(self):
        """The "sort" reduction's per-Gaussian sums (differences of f32
        running sums, B10's) against a float64 sum of each Gaussian's rows:
        each within bound[hi] + bound[lo] (rv.cumsum_rows_bound on the
        sorted [D, cap2] table, 0 at the leading zero column) plus one
        rounding of the difference (u / (1 - u) of its value) and the
        float64 sums' own (cap2 2^-53 times the column's sum of |rows|);
        raises otherwise. Reports the largest gap over that bound and, in
        each gradient column, over the column's largest |sum|."""
        from gscodec_studio_tpu_torch.ops import raster_v2 as rv

        rp, cfg = self.rp, self.cfg
        got = rp.segment_reduce(self.v_packed, self.al.ids,
                                self.isect.exp_offsets, self.al.inv_perm,
                                self.isect.n_isects,
                                dataclasses.replace(cfg, segred="sort"))
        ids = torch.where(self.al.ids >= 0, self.al.ids, cfg.m).long()
        vd = self.v_packed.double()
        exact = torch.zeros((cfg.m + 1, cfg.d), dtype=torch.float64,
                            device=got.device).index_add_(0, ids, vd)[:-1]
        cols = self.sorted_cols()
        cb = rv.cumsum_rows_bound(cols)
        cb = torch.cat([cb.new_zeros((cfg.d, 1)), cb], 1)
        del cols
        off = self.isect.exp_offsets.long()
        u = 2.0 ** -24
        allowed = ((cb[:, off[1:]] + cb[:, off[:-1]]).t()
                   + u / (1 - u) * got.double().abs()
                   + cfg.cap2 * 2.0 ** -53 * vd.abs().sum(0))
        del cb
        gap = (got.double() - exact).abs()
        if not bool((gap <= allowed).all()):
            raise AssertionError("a v1 \"sort\" per-Gaussian sum lies "
                                 "outside its running sums' rounding bound")
        by_col = gap.amax(0) / exact.abs().amax(0).clamp(min=1e-300)
        names = ["x", "y", "conic_a", "conic_b", "conic_c", "opacity"] + [
            f"color_{j}" for j in range(cfg.channels)]
        return {"max_gap_over_bound": float((gap / allowed).max()),
                "max_gap_over_scale": float(by_col.max()),
                "by_column": dict(zip(names, by_col.tolist())),
                "rows_summed": cfg.cap2}

    def kernel_numbers(self):
        """Time, plain time and bound of B7 and B8 on these inputs, the
        bound on their candidate slots (tile_bound, regions()) with the
        plain walk's beside it."""
        rp, cfg, pc = self.rp, self.cfg, self.pair_counts
        CH, P, T = cfg.channels, cfg.pixels, cfg.n_tiles
        d = cfg.d
        cand = self.regions()["candidate_slots"]
        k = {}
        k["raster_v1_fwd"] = tile_bound(dict(
            ms=cuda_ms(lambda: rp.raster_v1_fwd(*self.args, cfg), 10),
            plain_ms=once_ms(lambda: rp._fwd_plain(*self.args, cfg)),
            library_ms=None,
            bytes=4 * d * self.n_isects + 8 * T + 4 * T * P * (CH + 1),
            pair_counts=pc), pc, cand, V1_OPS_EVALUATED,
            FWD_OPS_TESTED[cfg.cutoff] * pc["tested"]
            + (1 + 2 * CH) * pc["composited"])
        k["raster_v1_bwd"] = tile_bound(dict(
            ms=cuda_ms(lambda: rp.raster_v1_bwd(*self.bwd_args), 10),
            plain_ms=once_ms(lambda: rp._bwd_plain(*self.plain_bwd_args)),
            library_ms=None,
            bytes=4 * d * self.n_isects + 8 * T + 4 * T * P * (CH + 3)
            + 4 * d * cfg.cap2,
            pair_counts=pc), pc, cand, V1_OPS_EVALUATED,
            FWD_OPS_TESTED[cfg.cutoff] * pc["tested"]
            + (V1_BWD_OPS_COMPOSITED + 3 * CH + d) * pc["composited"])
        return k


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gscodec_studio_tpu_torch import native
    from gscodec_studio_tpu_torch.models.splats import (from_jax_splats,
                                                        splat_activations)
    from gscodec_studio_tpu_torch.ops.projection import fully_fused_projection
    from gscodec_studio_tpu_torch.ops import raster_v2 as rv
    from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as r2
    from gscodec_studio_tpu_torch.ops import isect as ti
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    from gscodec_studio_tpu_torch.profiling import kernel_skel_bench as skel
    from gscodec_studio_tpu_torch.rendering import (_default_isect_capacity,
                                                    project_and_shade,
                                                    project_and_shade_2dgs,
                                                    rasterization,
                                                    rasterization_2dgs)
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner
    from gscodec_studio_tpu_torch.training.trainer_2dgs import (Config2DGS,
                                                                Runner2DGS)
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
    log_text = log.read_text() if log.exists() else ""
    entries = ptxas_entries(log_text)
    b6_ptxas = b6_instances(entries)
    b2_ptxas = tile_instances(entries, "raster_bwd_kernel")
    b1_ptxas = tile_instances(entries, "raster_fwd_kernel")
    b5_ptxas = tile_instances(entries, "raster_fwd_2dgs_kernel", "cbm")
    v1_ptxas = dict(b7_work=v1_instances(entries, "raster_v1_fwd_kernel"),
                    b8_work=v1_instances(entries, "raster_v1_bwd_kernel"))
    emit({"phase": "build", "library": so.name,
          "nvcc_seconds": native.build_seconds, "ptxas": entries,
          "raster_bwd_ptxas": b2_ptxas, "raster_bwd_2dgs_ptxas": b6_ptxas,
          "raster_fwd_ptxas": b1_ptxas, "raster_fwd_2dgs_ptxas": b5_ptxas,
          "raster_v1_fwd_ptxas": v1_ptxas["b7_work"],
          "raster_v1_bwd_ptxas": v1_ptxas["b8_work"],
          "pack_rows_ptxas": pack_instances(entries),
          "seconds": time.perf_counter() - t0})

    def to_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    def prepared(scene, width, height, elliptical=True):
        means, quats, scales, opac, colors, vm, Ks = to_dev(*scene)
        return project_and_shade(means, quats, scales, opac, colors, vm, Ks,
                                 width, height, sh_degree=3,
                                 elliptical=elliptical)

    def check_training_views(runner, sh_degree, errs, packed=False):
        """The kernels on the training run's own inputs: each training
        view at the run's splats, SH degree, intersection capacity and
        sorted-table precision. Times B2 (with ``packed``, its packed-pair
        branch) on every view with a seeded cotangent, then holds the
        slowest view's kernels, forward and backward (both branches),
        against their plain versions."""
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
                              cap=runner.isect_capacity(),
                              attr_dtype=tc.attr_dtype,
                              log_composite=tc.log_composite)

        bwd_ms = []
        with torch.no_grad():
            for i in range(data["image"].shape[0]):
                st = view_stages(i)
                st.cotangent(seed=100 + i)
                bwd_ms.append(cuda_ms(lambda: st.rv.raster_bwd(
                    st.b.S, st.b.starts, st.masks, st.out, st.v_tiles,
                    st.cfg, False, packed=packed), 2))
                del st
            view = int(np.argmax(bwd_ms))
            st = view_stages(view)
            res = st.compare(errs)
            res.update(st.compare_bwd(errs, seed=100 + view))
            res["b2_regions"] = region_summary(b2_regions(rv, st))
            res["b1_regions"] = region_summary(b1_regions(rv, st))
            res["b3_work"] = b3_work(rv, st)
        return dict(view=view, sh_degree=sh_degree, raster_bwd_ms=bwd_ms,
                    n_isects=int(st.b.n_isects), isect_capacity=st.cfg.cap,
                    cutoff=st.cfg.cutoff, **res)

    def check_training_views_2dgs(runner, sh_degree, errs):
        """check_training_views for Runner2DGS: B6 timed on every training
        view at the run's final splats and SH degree, then the slowest
        view's B5, B6, pack and no-cull expansion held against their plain
        versions, and B6's candidate regions checked to hold every passing
        slot there. The capacity is sized from each view's count."""
        tc = runner.cfg
        sp = runner.splats
        data = runner._device_trainset()
        H, W = data["image"].shape[1:3]
        with torch.no_grad():
            means, quats, scales, opac = splat_activations(sp)
            colors = torch.cat([sp["sh0"], sp["shN"]], 1)

        def view_stages(i):
            prep = project_and_shade_2dgs(
                means, quats, scales, opac, colors,
                torch.linalg.inv(data["camtoworld"][i:i + 1]),
                data["K"][i:i + 1], W, H, near_plane=tc.near_plane,
                far_plane=tc.far_plane, sh_degree=sh_degree)
            return stages_2dgs(prep, W, H, "exact")

        bwd_ms = []
        with torch.no_grad():
            for i in range(data["image"].shape[0]):
                st = view_stages(i)
                g = torch.Generator(device="cpu").manual_seed(200 + i)
                v = torch.randn(st.out.shape, generator=g).to(dev)
                bwd_ms.append(cuda_ms(lambda: st.r2.raster_bwd_2dgs(
                    st.b.S, st.b.starts, st.masks, st.out, v, st.cfg,
                    st.zch), 2))
                del st, v
            view = int(np.argmax(bwd_ms))
            st = view_stages(view)
            res = st.compare(errs)
            res.update(st.compare_bwd(errs, seed=200 + view))
            c6 = r2._bwd_2dgs_counts(st.b.S, st.b.starts, st.masks, st.cfg)
            if c6["missed_slots"]:
                raise AssertionError(f"{c6['missed_slots']} passing (pair, "
                                     f"pixel) slots outside B6's candidate "
                                     f"regions on a trained view")
            res["b6_regions"] = region_summary(c6)
            res["b5_regions"] = region_summary(b5_regions(r2, st))
            res["b4_work"] = rv.segsum_counts(st.b.cum, st.b.n_isects,
                                              st.gbuf.shape[0])
        return dict(view=view, sh_degree=sh_degree, raster_bwd_2dgs_ms=bwd_ms,
                    n_isects=int(st.b.n_isects), isect_capacity=st.cfg.cap,
                    **res)

    def check_training_views_v1(runner, sh_degree, errs):
        """check_training_views for the v1 backend: B8 timed on every
        training view at the run's final splats, SH degree and capacity,
        then the slowest view's B7 and B8 held against their plain
        versions on that view's own inputs."""
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
                antialiased=tc.antialiased, elliptical=False)
            return V1Stages(rp, ti, prep, W, H, tc.tile_size,
                            rp.CUTOFF_MODE, runner.isect_capacity())

        bwd_ms = []
        with torch.no_grad():
            for i in range(data["image"].shape[0]):
                st = view_stages(i)
                st.cotangent(seed=300 + i)
                bwd_ms.append(cuda_ms(lambda: rp.raster_v1_bwd(
                    *st.bwd_args), 2))
                del st
            view = int(np.argmax(bwd_ms))
            st = view_stages(view)
            res = st.compare(errs)
            res.update(st.compare_bwd(errs, seed=300 + view))
            res.update(st.work(v1_ptxas, tail=True),
                       order=st.order_numbers(),
                       cumsum_rows=st.scan_numbers(errs))
        return dict(view=view, sh_degree=sh_degree, raster_v1_bwd_ms=bwd_ms,
                    n_isects=st.n_isects, isect_capacity=st.cfg.cap,
                    cutoff=st.cfg.cutoff, **res)

    def stages_2dgs(prep, width, height, cutoff, cap=None, ts=16,
                    log_composite=False, absgrad=False):
        """Stages2DGS of project_and_shade_2dgs's outputs; the capacity,
        unless given, 1.2x the binned rows of a first count."""
        radii, means2d, depths, trans, normals, colors_cn, opac_cn = prep
        C, N = depths.shape
        TW, TH = -(-width // ts), -(-height // ts)
        if cap is None:
            _, _, _, cnt = rv.tile_counts(means2d, radii, ts, TW, TH)
            cap = int(1.2 * int(cnt.sum())) + 1
        cap = -(-cap // rv.CAP_BLOCK) * rv.CAP_BLOCK
        colors_full = torch.cat([colors_cn, normals], -1).contiguous()
        CB = colors_full.shape[-1]
        cfg = r2.cfg_2dgs(C, TW, TH, ts, CB, cap, N, cutoff=cutoff,
                          log_composite=log_composite, absgrad=absgrad)
        masks = torch.ones(cfg.n_tiles, dtype=torch.int32, device=dev)
        st = Stages2DGS(rv, r2, cfg, CB - 4, means2d.contiguous(),
                        trans.contiguous(), colors_full,
                        opac_cn.contiguous(), depths.contiguous(),
                        radii.contiguous(), masks)
        if int(st.b.n_isects) >= cfg.cap:
            raise AssertionError(f"2DGS stages filled the capacity "
                                 f"{cfg.cap}")
        return st

    def stages_for(prep, width, height, ts, cutoff, cap=None, **knobs):
        """Stages of project_and_shade's outputs; ``knobs`` are V2Cfg's
        precision fields."""
        return stages_of(rv, prep, width, height, ts, cutoff, cap, **knobs)

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
            res["b2_regions"] = region_summary(b2_regions(rv, st))
            res["b1_work"] = b1_work(rv, st, b1_ptxas)
            cases.append(dict(tile_size=ts, cutoff=cutoff,
                              n_isects=int(st.b.n_isects), **res))
    # B1 and B2 at 40 channels (the 64-channel instantiation)
    g40 = torch.Generator(device="cpu").manual_seed(40)
    colors40 = torch.rand(prep_small[4].shape[:2] + (40,),
                          generator=g40).to(dev)
    prep40 = prep_small[:4] + (colors40,) + prep_small[5:]
    for cutoff in ("exact", "soft"):
        for ts in (16, 32):  # tile 32: B1's 1024-thread wide build
            st = stages_for(prep40, sw, sh, ts, cutoff)
            res = st.compare(errs)
            if ts == 16:
                res.update(st.compare_bwd(errs, seed=40))
            res["b1_work"] = b1_work(rv, st, b1_ptxas)
            cases.append(dict(tile_size=ts, cutoff=cutoff, channels=40,
                              n_isects=int(st.b.n_isects), **res))
    # the sorted table's precision branches of B3, B1 and B2 (the backward
    # also with packed gradient rows)
    for name, knobs in PRECISION_CASES.items():
        for ts in (16, 32):
            for cutoff in ("exact", "soft"):
                st = stages_for(prep_small, sw, sh, ts, cutoff, **knobs)
                res = st.compare(errs)
                res.update(st.compare_bwd(errs, seed=ts))
                res["b2_regions"] = region_summary(b2_regions(rv, st))
                res["b1_regions"] = region_summary(b1_regions(rv, st))
                cases.append(dict(tile_size=ts, cutoff=cutoff, knobs=name,
                                  n_isects=int(st.b.n_isects), **res))
    # B5, B6 and B3's no-cull branch on the same scene's surfels
    means_s, quats_s, scales_s, opac_s, colors_s, vm_s, Ks_s = to_dev(
        *small)
    prep2_small = project_and_shade_2dgs(
        means_s, quats_s, scales_s, opac_s, colors_s, vm_s, Ks_s, sw, sh,
        sh_degree=3)
    for log_composite in (False, True):
        for cutoff in ("exact", "soft"):
            st = stages_2dgs(prep2_small, sw, sh, cutoff,
                             log_composite=log_composite)
            res = st.compare(errs)
            res.update(st.compare_bwd(errs, seed=2))
            cases.append(dict(tile_size=16, cutoff=cutoff, surfels=True,
                              log_composite=log_composite,
                              n_isects=int(st.b.n_isects),
                              b6_work=b6_work(r2, st, b6_ptxas),
                              b5_work=b5_work(r2, st, b5_ptxas), **res))
    del st
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "max_abs_err": errs,
          "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL,
          "segsum_bound": "2 gamma(n + 1) sum|x|",
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
        k = {}
        k["pack_rows"] = dict(
            ms=cuda_ms(lambda: rv.pack_rows(st.row_list, n, st.b.perm), 10),
            plain_ms=cuda_ms(
                lambda: rv._pack_rows_plain(st.row_list, n, st.b.perm), 3),
            library_ms=cuda_ms(
                lambda: torch.index_select(st.b.rows, 1, st.b.perm), 10),
            bytes=(4 * n + 8 + 4 * n) * L, ops=0,
            table_ms=cuda_ms(
                lambda: rv.pack_rows(st.attr_rows, cfg.n_attr_eff,
                                     st.b.order),
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
            library_ms=None, bytes=expand_bytes(rv, st.b, cfg), ops=0,
        )
        bound(k["pack_rows"])
        bound(k["expand"])
        b2_regions(rv, st)  # B1's counts too where the layouts agree
        k["raster_fwd"] = tile_bound(dict(
            ms=cuda_ms(lambda: rv.raster_fwd(st.b.S, st.b.starts, st.masks,
                                             cfg, order=st.runs), 10),
            plain_ms=cuda_ms(lambda: rv._fwd_plain(
                st.b.S, st.b.starts, st.masks, cfg), 1),
            library_ms=None,
            bytes=4 * (6 + cfg.channels) * n_isects
            + 4 * (cfg.n_tiles_v + 1) + 4 * cfg.n_tiles
            + 4 * cfg.n_tiles * cfg.pixels * (cfg.channels + 1),
            pair_counts=pc,
        ), pc, b1_regions(rv, st)["candidate_slots"], FWD_OPS_EVALUATED,
            FWD_OPS_TESTED[cutoff] * pc["tested"]
            + (1 + 2 * cfg.channels) * pc["composited"])
        # B1 in index order (a render with no backward) beside the
        # training path's longest-run-first order, in turns, and the
        # argsort that makes the order
        b1_order = dict(index_ms=[], ordered_ms=[], argsort_ms=cuda_ms(
            lambda: rv.run_order(st.b.starts, cfg), 10))
        for key in ("index_ms", "ordered_ms", "ordered_ms", "index_ms"):
            b1_order[key].append(cuda_ms(lambda: rv.raster_fwd(
                st.b.S, st.b.starts, st.masks, cfg,
                order=st.runs if key == "ordered_ms" else None), 10))
        # B2 at this tile size on a seeded cotangent (tile 16 beside 32),
        # and its candidate regions
        st.cotangent(ts)
        raster_bwd_ms = cuda_ms(lambda: rv.raster_bwd(
            st.b.S, st.b.starts, st.masks, st.out, st.v_tiles, cfg, False),
            10)
        b2_reg = region_summary(b2_regions(rv, st))
        rows_1m.append(dict(tile_size=ts, cutoff=cutoff, n_isects=n_isects,
                            rows_in_tiles=int(st.b.starts[cfg.n_tiles]
                                              - st.b.starts[0]),
                            isect_capacity=cfg.cap, render_ms=render_ms,
                            stage_ms=stage_ms,
                            launches_per_render=launches_per_render,
                            kernels=k, check=check,
                            raster_bwd_ms=raster_bwd_ms,
                            raster_bwd_build=rv.bwd_build(
                                cfg.channels, ts, dense=rv.bwd_dense(cfg)),
                            raster_fwd_build=rv.fwd_build(
                                cfg.channels, ts, dense=rv.bwd_dense(cfg)),
                            b2_regions=b2_reg,
                            b1_regions=region_summary(b1_regions(rv, st)),
                            b1_order=b1_order,
                            mean_alpha=float(alpha.mean())))
        if (ts, cutoff) == (16, "exact"):
            perf = k
        del st
    # B1 and B2 at tile 32 over tile 16 (exact)
    by_ts = {r["tile_size"]: r for r in rows_1m if r["cutoff"] == "exact"}
    tile32_over_16 = dict(
        raster_fwd=by_ts[32]["kernels"]["raster_fwd"]["ms"]
        / by_ts[16]["kernels"]["raster_fwd"]["ms"],
        raster_bwd=by_ts[32]["raster_bwd_ms"] / by_ts[16]["raster_bwd_ms"])
    emit({"phase": "scene_1m", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "binned_rows_tile16": binned_rows, "runs": rows_1m,
          "tile32_over_16": tile32_over_16,
          "seconds": time.perf_counter() - t0})

    def raster_grads(cfg, grad_dtype):
        """The rasterizer's gradients (means2d, conics, colours, opacities)
        at train_1m's projected inputs under a seeded cotangent."""
        radii, m2d, depths, conics, colors_cn, opac_cn = prep_1m[:6]
        xs = [x.detach().clone().requires_grad_(True)
              for x in (m2d, conics, colors_cn, opac_cn)]
        img, alpha, _ = rv.rasterize_to_pixels_v2(
            *xs, depths, radii, WIDTH, HEIGHT, tile_size=16,
            isect_capacity=cfg.cap, cutoff_mode=cfg.cutoff,
            grad_dtype=grad_dtype, device=dev)
        torch.autograd.backward([img, alpha], [ct_img, ct_alpha])
        return [x.grad for x in xs]

    def bf16_case(st, leaves, bwd_args):
        """grad_dtype "bf16" at train_1m's shapes (exact cutoff): fwd+bwd
        median and profile, the rasterizer's gradient rows against the f32
        case's (checked), the leaves' gradients against the last f32 call's
        (reported), and the packed branches' and the unpacks' times beside
        their f32 branches'."""
        cfg = st.cfg
        f32_grads = [t.grad.clone() for t in leaves]

        def fwd_bwd16():
            for t in leaves:
                t.grad = None
            out = rasterization(*leaves, vm, Ks, WIDTH, HEIGHT, sh_degree=3,
                                tile_size=16, isect_capacity=cfg.cap,
                                cutoff_mode=cfg.cutoff, grad_dtype="bf16",
                                device=dev)[0]
            torch.autograd.backward(out, ct_img)

        rv.reset_launch_counts()
        fwd_bwd16()
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
        if min(launches[k] for k in KERNELS_LADDER) < 1 or \
                launches["raster_bwd"] or launches["segsum_rows"]:
            raise AssertionError(f"the bf16 fwd+bwd did not take the packed "
                                 f"branches: {launches}")
        # reported: the leaves' gradients through projection and SH
        leaf_err = {name: float((t.grad - g).abs().max() / g.abs().max())
                    for name, t, g in zip(("means", "quats", "scales",
                                           "opacities", "colors"), leaves,
                                          f32_grads)}
        # checked: the rasterizer's gradient rows (x, y, ca, cb, cc, the
        # colours, opacity), each against its own scale in the f32 case
        raster = {gd: raster_grads(cfg, gd) for gd in ("f32", "bf16")}
        row_err = {}
        for name, a, b_ in zip(("means2d", "conics", "colors", "opacities"),
                               raster["bf16"], raster["f32"]):
            a, b_ = a.reshape(a.shape[1], -1), b_.reshape(b_.shape[1], -1)
            row_err[name] = ((a - b_).abs().amax(0)
                             / b_.abs().amax(0).clamp(min=1e-30)).tolist()
            if not all(math.isfinite(e) and e <= BF16_GRAD_TOL
                       for e in row_err[name]):
                raise AssertionError(f"bf16 {name} gradient rows off the f32 "
                                     f"ones by {row_err[name]} of their scale")
        fb_ms, fb_samples = median_ms(fwd_bwd16, 5)
        profile = device_profile(fwd_bwd16)
        CH, P, L = cfg.channels, cfg.pixels, cfg.cap
        n_rows = int(st.b.starts[cfg.n_tiles] - st.b.starts[0])
        pc = st.pair_counts
        d_g, d_p = cfg.d_g(False), cfg.d_gp(False)
        seg_pairs = rv.repack_sums(st.pseg, cfg.n_attr_eff, False)
        k = {}
        k["raster_bwd_packed"] = tile_bound(dict(
            ms=cuda_ms(lambda: rv.raster_bwd(*bwd_args, packed=True), 10),
            plain_ms=cuda_ms(lambda: rv._bwd_packed_plain(*bwd_args), 1),
            library_ms=None,
            bytes=4 * (6 + CH) * n_rows + 4 * (cfg.n_tiles_v + 1)
            + 4 * cfg.n_tiles + 2 * 4 * cfg.n_tiles * P * (CH + 1)
            + 4 * d_p * L,
            pair_counts=pc), pc, b2_regions(rv, st)["candidate_slots"],
            FWD_OPS_EVALUATED, FWD_OPS_TESTED[cfg.cutoff] * pc["tested"]
            + (BWD_OPS_COMPOSITED + 3 * CH + d_g) * pc["composited"])
        k["segsum_rows_packed"] = segsum_numbers(st, packed=True)
        unpack_ms = dict(
            packed_rows=d_p,
            packed_ms=cuda_ms(lambda: rv.unpack_rows(st.gpk, d_p, st.b.perm),
                              10),
            f32_ms=cuda_ms(lambda: rv.unpack_rows(st.gbuf, d_g, st.b.perm),
                           10),
            per_gaussian_packed_rows=seg_pairs.shape[0],
            per_gaussian_packed_ms=cuda_ms(lambda: rv.unpack_rows(
                seg_pairs, seg_pairs.shape[0], st.b.order), 10),
            per_gaussian_f32_ms=cuda_ms(lambda: rv.unpack_rows(
                st.seg, d_g, st.b.order), 10))
        return dict(fwd_bwd_ms=fb_ms, fwd_bwd_ms_samples=fb_samples,
                    mpix_per_s=WIDTH * HEIGHT / (fb_ms * 1e-3) / 1e6,
                    launches_per_fwd_bwd=launches,
                    raster_row_err_vs_f32=row_err, grad_tol=BF16_GRAD_TOL,
                    leaf_grad_err_vs_f32=leaf_err, kernels=k, unpack=unpack_ms,
                    profile=profile)

    # 6. train_1m: forward + backward at 1M, and the backward kernels
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(7)
    ct_img = torch.randn((1, HEIGHT, WIDTH, 3), generator=g).to(dev)
    ct_alpha = torch.randn((1, HEIGHT, WIDTH, 1), generator=g).to(dev)
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
        if min(launches[k] for k in KERNELS_3DGS) < 1:
            raise AssertionError(f"a kernel did not launch in fwd+bwd: "
                                 f"{launches}")
        if not all(bool(torch.isfinite(t.grad).all()) for t in leaves):
            raise AssertionError("train_1m gradients are not finite")
        fb_ms, fb_samples = median_ms(fwd_bwd, 5)
        with torch.no_grad():
            f_ms, _ = median_ms(forward, 5)
        profile = device_profile(fwd_bwd)

        CH, P, L = cfg.channels, cfg.pixels, cfg.cap
        d_g = cfg.d_g(False)
        n_isects = int(st.b.n_isects)
        n_rows = int(st.b.starts[cfg.n_tiles] - st.b.starts[0])
        pc = st.pair_counts
        bwd_args = (st.b.S, st.b.starts, st.masks, st.out, st.v_tiles, cfg,
                    False)
        k = {}
        k["raster_bwd"] = tile_bound(dict(
            ms=cuda_ms(lambda: rv.raster_bwd(*bwd_args), 10),
            plain_ms=cuda_ms(lambda: rv._bwd_plain(*bwd_args), 1),
            library_ms=None,
            bytes=4 * (6 + CH) * n_rows + 4 * (cfg.n_tiles_v + 1)
            + 4 * cfg.n_tiles + 2 * 4 * cfg.n_tiles * P * (CH + 1)
            + 4 * d_g * L,
            pair_counts=pc), pc, b2_regions(rv, st)["candidate_slots"],
            FWD_OPS_EVALUATED, FWD_OPS_TESTED[cutoff] * pc["tested"]
            + (BWD_OPS_COMPOSITED + 3 * CH + d_g) * pc["composited"])
        k["segsum_rows"] = segsum_numbers(st)
        k["unpack_rows"] = unpack_numbers(st)
        run = dict(
            tile_size=16, cutoff=cutoff, n_isects=n_isects,
            rows_in_tiles=n_rows, isect_capacity=L, fwd_bwd_ms=fb_ms,
            fwd_bwd_ms_samples=fb_samples, fwd_ms=f_ms,
            mpix_per_s=WIDTH * HEIGHT / (fb_ms * 1e-3) / 1e6,
            launches_per_fwd_bwd=launches, kernels=k, profile=profile,
            check=dict(fwd_check, **bwd_check))
        if cutoff == "exact":
            perf.update(k)
            run["b4_work"] = rv.segsum_counts(st.b.cum, st.b.n_isects, d_g)
            run["b2_work"] = b2_work(rv, st, b2_ptxas, cuda_ms)
            run["b1_work"] = b1_work(rv, st, b1_ptxas, cuda_ms)
            run["b3_work"] = b3_work(rv, st)
            run["bf16"] = bf16_case(st, leaves, bwd_args)
            perf.update(run["bf16"]["kernels"])
        runs_bwd.append(run)
        del st
    # B1 and B2 at 40 channels at these shapes (the 64-channel
    # instantiation)
    g40 = torch.Generator(device="cpu").manual_seed(41)
    colors40 = torch.rand(prep_1m[4].shape[:2] + (40,), generator=g40).to(
        dev)
    st = stages_for(prep_1m[:4] + (colors40,) + prep_1m[5:], WIDTH, HEIGHT,
                    16, "exact")
    st.cotangent(40)
    # B1 against its plain version here: within FWD_TOL but at the rare
    # pixels where the two round a pair's transmittance to either side of
    # the exact cutoff (cutoff_flips; at most one pixel in 10^4), and its
    # bound on its candidate slots
    ref40, pc40 = rv._fwd_plain(st.b.S, st.b.starts, st.masks, st.cfg,
                                with_counts=True)
    flips40 = cutoff_flips(st.out, ref40, float(colors40.max()), rv)
    err40 = flips40["max_abs_err"]
    if not (math.isfinite(err40) and flips40["unexplained"] == 0
            and flips40["pixels_over_tol"] * 10**4 <= flips40["pixels"]):
        raise AssertionError(f"raster_fwd at 40 channels: {flips40}")
    del ref40
    rows40 = int(st.b.starts[st.cfg.n_tiles] - st.b.starts[0])
    wide40 = dict(
        channels=40, n_isects=int(st.b.n_isects),
        raster_fwd_build=rv.fwd_build(40, 16),
        raster_fwd=tile_bound(dict(
            ms=cuda_ms(lambda: rv.raster_fwd(
                st.b.S, st.b.starts, st.masks, st.cfg, order=st.runs), 5),
            max_abs_err=err40, cutoff_flips=flips40, pair_counts=pc40,
            bytes=4 * (6 + 40) * rows40 + 4 * (st.cfg.n_tiles_v + 1)
            + 4 * st.cfg.n_tiles + 4 * st.cfg.n_tiles * st.cfg.pixels * 41),
            pc40, b1_regions(rv, st)["candidate_slots"], FWD_OPS_EVALUATED,
            FWD_OPS_TESTED["exact"] * pc40["tested"]
            + (1 + 2 * 40) * pc40["composited"]),
        raster_bwd_ms=cuda_ms(lambda: rv.raster_bwd(
            st.b.S, st.b.starts, st.masks, st.out, st.v_tiles, st.cfg,
            False), 3))
    wide40["raster_fwd_ms"] = wide40["raster_fwd"]["ms"]
    del st, colors40
    emit({"phase": "train_1m", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "runs": runs_bwd, "wide40": wide40,
          "seconds": time.perf_counter() - t0})

    # 7. train_1m_2dgs: the same scene's surfels through rasterization_2dgs
    t0 = time.perf_counter()
    prep2_1m = project_and_shade_2dgs(means, quats, scales, opac, colors, vm,
                                      Ks, WIDTH, HEIGHT, sh_degree=3)
    st = stages_2dgs(prep2_1m, WIDTH, HEIGHT, "exact")
    cfg2 = st.cfg
    check2 = st.compare(errs)
    check2.update(st.compare_bwd(errs, seed=26))
    g = torch.Generator(device="cpu").manual_seed(8)
    cts = [torch.randn((1, HEIGHT, WIDTH, c), generator=g).to(dev)
           for c in (3, 1, 3, 1)]
    leaves2 = [t.detach().clone().requires_grad_(True)
               for t in (means, quats, scales, opac, colors)]

    def forward_2dgs():
        return rasterization_2dgs(*leaves2, vm, Ks, WIDTH, HEIGHT,
                                  sh_degree=3, tile_size=16,
                                  isect_capacity=cfg2.cap,
                                  rasterizer="fused", device=dev)

    def fwd_bwd_2dgs():
        for t in leaves2:
            t.grad = None
        out = forward_2dgs()
        # colours, alphas, normals and distortion: the four kernel outputs
        # that carry a gradient (the median has none)
        torch.autograd.backward([out[0], out[1], out[2], out[4]], cts)

    rv.reset_launch_counts()
    fwd_bwd_2dgs()
    torch.cuda.synchronize()
    launches2 = dict(rv.LAUNCHES)
    if min(launches2[k] for k in KERNELS_2DGS) < 1:
        raise AssertionError(f"a kernel did not launch in the 2DGS "
                             f"fwd+bwd: {launches2}")
    if not all(bool(torch.isfinite(t.grad).all()) for t in leaves2):
        raise AssertionError("train_1m_2dgs gradients are not finite")
    with torch.no_grad():
        out2 = forward_2dgs()
    if int(out2[6]["n_isects"]) != int(st.b.n_isects) or not all(
            bool(torch.isfinite(x).all()) for x in out2[:6]):
        raise AssertionError("train_1m_2dgs render disagrees with its "
                             "stages")
    fb2_ms, fb2_samples = median_ms(fwd_bwd_2dgs, 5)
    with torch.no_grad():
        f2_ms, _ = median_ms(forward_2dgs, 5)
    profile2 = device_profile(fwd_bwd_2dgs)
    k2 = st.kernel_numbers(cuda_ms)
    work2 = b6_work(r2, st, b6_ptxas, cuda_ms)
    work5 = b5_work(r2, st, b5_ptxas, cuda_ms)
    work3 = b3_work(rv, st)
    # B5 in the longest-run-first tile order (rv.run_order, which B6 does
    # not take) beside index order, the path's, in turns, with the same
    # bits, and the argsort the order costs
    runs2 = rv.run_order(st.b.starts, cfg2)
    fwd2_args = (st.b.S, st.b.starts, st.masks, cfg2, st.zch)
    if not torch.equal(st.out, r2.raster_fwd_2dgs(*fwd2_args, order=runs2)):
        raise AssertionError("raster_fwd_2dgs differs in the longest-run-"
                             "first order")
    b5_order = dict(index_ms=[], ordered_ms=[], argsort_ms=cuda_ms(
        lambda: rv.run_order(st.b.starts, cfg2), 10))
    for key in ("index_ms", "ordered_ms", "ordered_ms", "index_ms"):
        b5_order[key].append(cuda_ms(lambda: r2.raster_fwd_2dgs(
            *fwd2_args, order=runs2 if key == "ordered_ms" else None), 10))
    # B9a on the surfels' two gathers beside their library calls
    pack2 = dict(
        S_ms=cuda_ms(lambda: rv.pack_rows(list(st.b.rows), cfg2.d_s,
                                          st.b.perm), 10),
        S_library_ms=cuda_ms(lambda: torch.index_select(st.b.rows, 1,
                                                        st.b.perm), 10),
        table_ms=cuda_ms(lambda: rv.pack_rows(st.attr_rows, cfg2.n_attr_eff,
                                              st.b.order), 10),
        table_library_ms=cuda_ms(
            lambda: torch.stack(st.attr_rows)[:, st.b.order], 10),
        rows=cfg2.d_s, columns=cfg2.cap, table_rows=cfg2.n_attr_eff)
    expand_no_cull_ms = cuda_ms(lambda: rv.expand(
        st.b.cum, st.b.base, st.b.nx, st.b.table, st.b.n_isects, cfg2), 10)
    # the no-cull branch's bound: B3's bytes at these shapes
    expand_no_cull = bound(dict(
        ms=expand_no_cull_ms, ops=0, bytes=expand_bytes(rv, st.b, cfg2)))
    perf.update(k2)
    n_rows2 = int(st.b.starts[cfg2.n_tiles] - st.b.starts[0])
    n_isects2 = int(st.b.n_isects)
    # B4 and B9b on the surfels' gradient rows beside index_add_ and
    # index_copy_, with their bounds, and B4's work
    segsum2 = dict(segsum_numbers(st), rows=cfg2.d_g(False),
                   intersections=n_isects2)
    unpack2 = unpack_numbers(st)
    work4 = rv.segsum_counts(st.b.cum, st.b.n_isects, cfg2.d_g(False))

    # the log scan's leg: rasterization_2dgs(log_composite=True), B5/B6's
    # log branch held against its plain version on its own inputs
    del st
    st = stages_2dgs(prep2_1m, WIDTH, HEIGHT, "exact", cap=cfg2.cap,
                     log_composite=True)
    check2_log = st.compare(errs)
    check2_log.update(st.compare_bwd(errs, seed=27))

    def fwd_bwd_2dgs_log():
        for t in leaves2:
            t.grad = None
        out = rasterization_2dgs(*leaves2, vm, Ks, WIDTH, HEIGHT,
                                 sh_degree=3, tile_size=16,
                                 isect_capacity=cfg2.cap, rasterizer="fused",
                                 log_composite=True, device=dev)
        torch.autograd.backward([out[0], out[1], out[2], out[4]], cts)

    rv.reset_launch_counts()
    fwd_bwd_2dgs_log()
    torch.cuda.synchronize()
    launches2_log = dict(rv.LAUNCHES)
    if min(launches2_log[k] for k in ("raster_fwd_2dgs_log",
                                      "raster_bwd_2dgs_log")) < 1 or \
            launches2_log["raster_fwd_2dgs"] or \
            launches2_log["raster_bwd_2dgs"]:
        raise AssertionError(f"the 2DGS log fwd+bwd did not take the log "
                             f"branches: {launches2_log}")
    if not all(bool(torch.isfinite(t.grad).all()) for t in leaves2):
        raise AssertionError("train_1m_2dgs log gradients are not finite")
    fb2l_ms, fb2l_samples = median_ms(fwd_bwd_2dgs_log, 5)
    k2_log = st.kernel_numbers(cuda_ms)
    perf.update(k2_log)
    log_leg = dict(fwd_bwd_ms=fb2l_ms, fwd_bwd_ms_samples=fb2l_samples,
                   mpix_per_s=WIDTH * HEIGHT / (fb2l_ms * 1e-3) / 1e6,
                   launches_per_fwd_bwd=launches2_log, kernels=k2_log,
                   n_isects=int(st.b.n_isects), check=check2_log)

    # B6's absgrad rows: one fwd+bwd of rasterize_to_pixels_2dgs_v2 with a
    # probe on these inputs (the branch's launch), and the rows held
    # against their plain version, twice for the same bits
    del st
    st = stages_2dgs(prep2_1m, WIDTH, HEIGHT, "exact", cap=cfg2.cap,
                     absgrad=True)
    check2_abs = st.compare(errs)
    check2_abs.update(st.compare_bwd(errs, seed=28))
    radii2, m2d2, dep2, trans2, nrm2, col2, op2 = prep2_1m
    leaves_ag = [x.detach().clone().requires_grad_(True)
                 for x in (m2d2, trans2, col2, op2, nrm2)]
    probe = torch.zeros(m2d2.shape, device=dev, requires_grad=True)
    g = torch.Generator(device="cpu").manual_seed(11)
    rv.reset_launch_counts()
    out_ag = r2.rasterize_to_pixels_2dgs_v2(
        *leaves_ag, dep2, radii2, WIDTH, HEIGHT, tile_size=16,
        isect_capacity=cfg2.cap, absgrad_probe=probe, device=dev)
    torch.autograd.backward(list(out_ag[:4]), [
        torch.randn(o.shape, generator=g).to(dev) for o in out_ag[:4]])
    torch.cuda.synchronize()
    launches2_abs = dict(rv.LAUNCHES)
    if launches2_abs["raster_bwd_2dgs_absgrad"] != 1 or \
            launches2_abs["raster_bwd_2dgs"]:
        raise AssertionError(f"the probed 2DGS fwd+bwd did not take B6's "
                             f"absgrad rows: {launches2_abs}")
    ag = probe.grad
    if not (bool(torch.isfinite(ag).all()) and bool((ag >= 0).all())
            and float(ag.sum()) > 0):
        raise AssertionError("the absgrad probe's gradient is not finite, "
                             "non-negative and non-zero")
    k2_abs = st.kernel_numbers(cuda_ms)
    perf["raster_bwd_2dgs_absgrad"] = k2_abs["raster_bwd_2dgs_absgrad"]
    absgrad_leg = dict(launches_per_fwd_bwd=launches2_abs,
                       kernel=k2_abs["raster_bwd_2dgs_absgrad"],
                       probe_grad_sum=float(ag.sum()),
                       probed_surfels=int((ag.sum(-1) > 0).sum()),
                       check=check2_abs)
    del out_ag, leaves_ag, probe, ag
    # B5 at tile 32 (512 threads at 2 pixels a thread) beside tile 16
    del st
    st = stages_2dgs(prep2_1m, WIDTH, HEIGHT, "exact", ts=32)
    b5_tile32 = dict(check=st.compare(errs), build=r2.fwd_build(
        cfg2.channels, 32), ms=cuda_ms(lambda: r2.raster_fwd_2dgs(
            st.b.S, st.b.starts, st.masks, st.cfg, st.zch), 10),
        tile16_ms=k2["raster_fwd_2dgs"]["ms"])
    emit({"phase": "train_1m_2dgs", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "tile_size": 16, "cutoff": cfg2.cutoff,
          "channels": cfg2.channels, "n_isects": n_isects2,
          "rows_in_tiles": n_rows2, "isect_capacity": cfg2.cap,
          "fwd_bwd_ms": fb2_ms, "fwd_bwd_ms_samples": fb2_samples,
          "fwd_ms": f2_ms,
          "mpix_per_s": WIDTH * HEIGHT / (fb2_ms * 1e-3) / 1e6,
          "launches_per_fwd_bwd": launches2, "kernels": k2,
          "b6_work": work2, "b5_work": work5, "b5_tile32": b5_tile32,
          "b5_order": b5_order,
          "pack_rows_2dgs": pack2,
          "segsum_rows_2dgs": segsum2, "unpack_rows_2dgs": unpack2,
          "b4_work": work4, "b3_work": work3,
          "expand_no_cull": expand_no_cull,
          "mean_alpha": float(out2[1].mean()), "profile": profile2,
          "check": check2, "log_composite": log_leg, "absgrad": absgrad_leg,
          "seconds": time.perf_counter() - t0})
    del st, out2, leaves2, prep2_1m

    # 8. bench_1m: bench.py's default configuration through the port
    t0 = time.perf_counter()
    ts_b = 32
    twb, thb = -(-WIDTH // ts_b), -(-HEIGHT // ts_b)
    # bench.py's probe: the opacity-aware elliptical rows at its tile size
    radii_b, m2d_b = fully_fused_projection(
        means, None, quats, scales, vm, Ks, WIDTH, HEIGHT, opacities=opac,
        elliptical=True)[:2]
    cnt_b = rv.tile_counts(m2d_b, radii_b, ts_b, twb, thb)[3]
    binned_rows_b = int(cnt_b.sum())
    cap_b = int(binned_rows_b * 1.2)
    # the centres that u16 positions clip: binned, outside [-4096, 4096) px
    outside_b = int(((cnt_b > 0) & ((m2d_b < -4096.0)
                                    | (m2d_b >= 4096.0)).any(-1)).sum())
    del radii_b, m2d_b, cnt_b
    legs = {
        "bench": dict(grad_dtype="bf16", attr_dtype="bf16",
                      log_composite=True, geom_dtype="f32"),
        "f32": dict(grad_dtype="f32", attr_dtype="f32", log_composite=False,
                    geom_dtype="f32"),
        "u16": dict(grad_dtype="bf16", attr_dtype="bf16",
                    log_composite=True, geom_dtype="u16"),
    }
    means_b = means.detach().clone().requires_grad_(True)

    def bench_fwd_bwd(knobs):
        def run():
            means_b.grad = None
            img, alpha, meta = rasterization(
                means_b, quats, scales, opac, colors, vm, Ks, WIDTH, HEIGHT,
                sh_degree=3, isect_capacity=cap_b, cutoff_mode="soft",
                tile_size=ts_b, device=dev, **knobs)
            loss = torch.mean((img - 0.5) ** 2) + 0.1 * torch.mean(alpha)
            loss.backward()
            return loss, meta
        return run

    legs_out, grads_b = {}, {}
    for leg, knobs in legs.items():
        run = bench_fwd_bwd(knobs)
        rv.reset_launch_counts()
        loss, meta = run()
        torch.cuda.synchronize()
        launches = dict(rv.LAUNCHES)
        want, off = (KERNELS_3DGS, [k for k in launches if k not in
                                    KERNELS_3DGS]) if leg == "f32" else (
            KERNELS_BENCH, F32_BRANCHES)
        if min(launches[k] for k in want) < 1 or any(launches[k]
                                                     for k in off):
            raise AssertionError(f"bench_1m {leg} leg launched {launches}")
        n_b = int(meta["n_isects"])
        if not (math.isfinite(float(loss)) and n_b < cap_b and
                bool(torch.isfinite(means_b.grad).all())):
            raise AssertionError(f"bench_1m {leg}: loss {float(loss)}, "
                                 f"n_isects {n_b} of {cap_b}")
        grads_b[leg] = means_b.grad.clone()
        ms, samples = median_ms(run, 10)
        legs_out[leg] = dict(knobs=knobs, fwd_bwd_ms=ms,
                             fwd_bwd_ms_samples=samples,
                             mpix_per_s=WIDTH * HEIGHT / (ms * 1e-3) / 1e6,
                             n_isects=n_b, loss=float(loss),
                             launches_per_fwd_bwd=launches)
    bench_launches = legs_out["bench"]["launches_per_fwd_bwd"]
    # reported: the means' gradients against the f32 leg's
    g_scale = float(grads_b["f32"].abs().max())
    for leg in ("bench", "u16"):
        legs_out[leg]["means_grad_err_vs_f32"] = float(
            (grads_b[leg] - grads_b["f32"]).abs().max()) / g_scale
    legs_out["u16"]["binned_centres_outside_u16_range"] = outside_b
    legs_out["bench"]["profile"] = device_profile(
        bench_fwd_bwd(legs["bench"]))
    del grads_b

    def tile_numbers(st):
        """B3's, B1's and B2's (f32 and packed gradient rows) time, plain
        time and bound at a Stages' inputs, in its cfg's branches (B2 on
        compare_bwd's cotangent; the tile kernels' by tile_bound)."""
        cfg, b = st.cfg, st.b
        CH, P, L = cfg.channels, cfg.pixels, cfg.cap
        n_rows = int(b.starts[cfg.n_tiles] - b.starts[0])
        pc = st.pair_counts
        tested = tested_ops(cfg) * pc["tested"]
        table_bytes = (4 * cfg.n_srows * n_rows + 4 * (cfg.n_tiles_v + 1)
                       + 4 * cfg.n_tiles)
        tile_bytes = 4 * cfg.n_tiles * P * (CH + 1)
        bwd_args = (b.S, b.starts, st.masks, st.out, st.v_tiles, cfg, False)
        bwd_rest = tested + (BWD_OPS_COMPOSITED + 3 * CH + cfg.d_g(False)) \
            * pc["composited"]
        cand2 = b2_regions(rv, st)["candidate_slots"]
        cand1 = b1_regions(rv, st)["candidate_slots"]  # B2's where they agree
        exp_args = (b.cum, b.base, b.nx, b.table, b.n_isects, cfg)
        return dict(
            expand=bound(dict(
                ms=cuda_ms(lambda: rv.expand(*exp_args), 10),
                plain_ms=once_ms(lambda: rv._expand_plain(*exp_args)),
                library_ms=None, ops=0, bytes=expand_bytes(rv, b, cfg))),
            raster_fwd=tile_bound(dict(
                ms=cuda_ms(lambda: rv.raster_fwd(b.S, b.starts, st.masks,
                                                 cfg, order=st.runs), 10),
                plain_ms=once_ms(lambda: rv._fwd_plain(b.S, b.starts,
                                                       st.masks, cfg)),
                library_ms=None, bytes=table_bytes + tile_bytes,
                pair_counts=pc), pc, cand1, FWD_OPS_EVALUATED,
                tested + (1 + 2 * CH) * pc["composited"]),
            raster_bwd=tile_bound(dict(
                ms=cuda_ms(lambda: rv.raster_bwd(*bwd_args), 10),
                plain_ms=once_ms(lambda: rv._bwd_plain(*bwd_args)),
                library_ms=None,
                bytes=table_bytes + 2 * tile_bytes
                + 4 * cfg.d_g(False) * L), pc, cand2, FWD_OPS_EVALUATED,
                bwd_rest),
            raster_bwd_packed=tile_bound(dict(
                ms=cuda_ms(lambda: rv.raster_bwd(*bwd_args, packed=True), 10),
                plain_ms=once_ms(lambda: rv._bwd_packed_plain(*bwd_args)),
                library_ms=None,
                bytes=table_bytes + 2 * tile_bytes
                + 4 * cfg.d_gp(False) * L), pc, cand2, FWD_OPS_EVALUATED,
                bwd_rest))

    # each branch's kernels on these inputs: against their plain versions
    # (B2 with f32 and packed gradient rows), then timed beside the f32
    # branch's
    configs_b = {"f32": {}, "attr_bf16": dict(attr_dtype="bf16"),
                 "log": dict(log_composite=True),
                 "bench": dict(attr_dtype="bf16", log_composite=True),
                 "u16": dict(attr_dtype="bf16", log_composite=True,
                             geom_dtype="u16")}
    kern_b, checks_b = {}, {}
    for name, knobs in configs_b.items():
        st = stages_for(prep_1m, WIDTH, HEIGHT, ts_b, "soft", cap=cap_b,
                        **knobs)
        checks_b[name] = st.compare(errs)
        checks_b[name].update(st.compare_bwd(errs, seed=32,
                                             absgrads=(False,)))
        checks_b[name]["n_isects"] = int(st.b.n_isects)
        if name == "bench":
            checks_b[name]["b2_work"] = b2_work(rv, st, b2_ptxas, cuda_ms)
            checks_b[name]["b1_work"] = b1_work(rv, st, b1_ptxas, cuda_ms)
            checks_b[name]["b3_work"] = b3_work(rv, st)
        kern_b[name] = tile_numbers(st)
        del st
    # the kernel table's rows of the new branches: each alone
    perf["expand_packed"] = kern_b["attr_bf16"]["expand"]
    perf["raster_fwd_unpack"] = kern_b["attr_bf16"]["raster_fwd"]
    perf["raster_bwd_unpack"] = kern_b["attr_bf16"]["raster_bwd"]
    perf["raster_fwd_log"] = kern_b["log"]["raster_fwd"]
    perf["raster_bwd_log"] = kern_b["log"]["raster_bwd"]
    emit({"phase": "bench_1m", "gaussians": N_1M, "width": WIDTH,
          "height": HEIGHT, "tile_size": ts_b, "cutoff": "soft",
          "binned_rows": binned_rows_b, "isect_capacity": cap_b,
          "legs": legs_out, "kernels_by_config": kern_b,
          "checks_by_config": checks_b,
          "seconds": time.perf_counter() - t0})
    del means_b

    # 9. train: the port's Runner on the checkpoint stand-in
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

    def timed_step(idx, sh_degree, step=0):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = train_step(idx, sh_degree, step)  # ends in a host sync
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
    if min(train_launches[k] for k in KERNELS_3DGS) < 1:
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
    # the entropy_codec phase's histogram tables, on this run's splats
    codec_runs = [entropy_codec_run(runner, dev, "histogram", TRAIN_STEPS)]
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)

    # 10. train_2dgs: the port's Runner2DGS on the same stand-in
    t0 = time.perf_counter()
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_train_2dgs_")
    tcfg2 = Config2DGS(result_dir=stats_dir, refine_start_iter=5,
                       refine_every=10, sh_degree_interval=5,
                       normal_start_iter=5, dist_start_iter=5)
    runner = Runner2DGS(tcfg2, parser=parser, trainset=trainset,
                        valset=valset, device=dev)
    before2 = runner.eval("before")
    steps = []
    train_step = runner.train_step
    runner.train_step = timed_step
    t1 = time.perf_counter()
    rv.reset_launch_counts()
    losses2 = runner.train(max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train2_launches = dict(rv.LAUNCHES)
    train2_s = time.perf_counter() - t1
    after2 = runner.eval("after")
    train2_check = check_training_views_2dgs(runner, steps[-1]["sh_degree"],
                                             errs)
    refines2 = [e for e in runner.events if e["event"] == "refine"]
    # the normal and distortion terms join the loss after step 5: the
    # loss must fall from the first steps with them to the last
    gated = losses2[tcfg2.normal_start_iter + 1:]
    loss2_first, loss2_gated, loss2_last = losses2[:5], gated[:5], gated[-5:]
    if not np.mean(loss2_last) < np.mean(loss2_gated):
        raise AssertionError(f"2DGS train loss did not fall: {losses2}")
    if not after2["psnr"] > before2["psnr"]:
        raise AssertionError(f"2DGS held-out PSNR did not rise: {before2} "
                             f"-> {after2}")
    if min(train2_launches[k] for k in KERNELS_2DGS) < 1:
        raise AssertionError(f"a kernel did not launch in 2DGS training: "
                             f"{train2_launches}")
    if runner.skipped_steps or len(refines2) < 2:
        raise AssertionError(f"2DGS skipped {runner.skipped_steps}, "
                             f"refines {refines2}")
    emit({"phase": "train_2dgs",
          "checkpoint": str(CHECKPOINT.relative_to(ROOT)), "views": 8,
          "train_views": len(trainset), "width": WIDTH, "height": HEIGHT,
          "steps": TRAIN_STEPS, "capacity": runner.splats["means"].shape[0],
          "isect_capacity": runner.isect_capacity(),
          "normal_start_iter": tcfg2.normal_start_iter,
          "dist_start_iter": tcfg2.dist_start_iter,
          "loss_first5": loss2_first, "loss_gated_first5": loss2_gated,
          "loss_last5": loss2_last,
          "psnr_before": before2["psnr"], "psnr_after": after2["psnr"],
          "ssim_before": before2["ssim"], "ssim_after": after2["ssim"],
          "step_ms_median": float(np.median([s["ms"] for s in steps])),
          "step_ms": [s["ms"] for s in steps],
          "n_isects": [s["n_isects"] for s in steps],
          "events": runner.events, "skipped_steps": runner.skipped_steps,
          "launches": train2_launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in train2_launches.items()},
          "view_check": train2_check, "train_seconds": train2_s,
          "seconds": time.perf_counter() - t0})
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)

    # 11. train_ladder: the garden ladder's recipe on the same stand-in
    t0 = time.perf_counter()
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_ladder_")
    lcfg = Config(result_dir=stats_dir, strategy="mcmc",
                  mcmc_cap_max=LADDER_CAP, opacity_reg=0.01, scale_reg=0.01,
                  compression_sim=True, entropy_model_opt=True,
                  shN_ada_mask_opt=True, rd_lambda=0.01, grad_dtype="bf16",
                  refine_start_iter=5, refine_every=10, sh_degree_interval=5)
    runner = Runner(lcfg, parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    sim = runner.compression_sim
    print(f"train_ladder: entropy_steps {sim.entropy_steps} and "
          f"ada_mask_start {sim.ada_mask_start} moved to {LADDER_GATE}, so "
          f"that the entropy models and the shN mask carry gradient within "
          f"{TRAIN_STEPS} steps", flush=True)
    sim.entropy_steps = {k: LADDER_GATE for k in sim.entropy_steps}
    sim.ada_mask_start = LADDER_GATE
    sim_init = {k: v.clone() for k, v in runner.sim_params.items()}
    n_init = int(runner.strategy_state["allocated"].sum())
    before_l = runner.eval("before")
    steps = []
    train_step = runner.train_step
    runner.train_step = timed_step
    t1 = time.perf_counter()
    rv.reset_launch_counts()
    losses_l = runner.train(max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    ladder_launches = dict(rv.LAUNCHES)
    ladder_s = time.perf_counter() - t1
    after_l = runner.eval("after")
    ladder_check = check_training_views(runner, steps[-1]["sh_degree"], errs,
                                        packed=True)
    moved = {k: float((v - sim_init[k]).abs().max())
             for k, v in runner.sim_params.items()}
    skipped_l = runner.skipped_steps
    step_profiles_l = {}
    for view in range(len(trainset)):
        prof = device_profile(lambda: train_step([view], 3, TRAIN_STEPS),
                              reps=1)
        step_profiles_l[view] = dict(prof, top=prof.get("top", [])[:8])
    refines_l = [e for e in runner.events if e["event"] == "refine"]
    # ceil(1.05 n) in float32, as the strategy computes it
    want_alloc, n = [], n_init
    for _ in refines_l:
        n = min(LADDER_CAP, int(np.ceil(np.float32(n) * np.float32(1.05))))
        want_alloc.append(n)
    alloc = [e["allocated"] for e in refines_l]
    gated_l = losses_l[LADDER_GATE + 1:]
    bits = [s_["bits"] for s_ in steps[:TRAIN_STEPS]]
    if not np.mean(gated_l[-5:]) < np.mean(gated_l[:5]):
        raise AssertionError(f"ladder loss did not fall: {losses_l}")
    if not after_l["psnr"] > before_l["psnr"]:
        raise AssertionError(f"ladder held-out PSNR did not rise: {before_l} "
                             f"-> {after_l}")
    if skipped_l or [e["step"] for e in refines_l] != [
            10, 20, 30] or alloc != want_alloc:
        raise AssertionError(f"ladder skipped {skipped_l}, "
                             f"refines {refines_l}, allocated {alloc} "
                             f"against {want_alloc}")
    if not all(e["live"] <= e["allocated"] for e in refines_l):
        raise AssertionError(f"ladder live above allocated: {refines_l}")
    if not (all(math.isfinite(b_) for b_ in bits)
            and min(bits[LADDER_GATE + 1:]) > 0):
        raise AssertionError(f"ladder bits not finite and positive: {bits}")
    if min(moved.values()) <= 0:
        raise AssertionError(f"a sim parameter did not move: {moved}")
    if min(ladder_launches[k] for k in KERNELS_LADDER) < 1 or \
            ladder_launches["raster_bwd"] or ladder_launches["segsum_rows"]:
        raise AssertionError(f"the ladder did not take the packed branches: "
                             f"{ladder_launches}")
    emit({"phase": "train_ladder",
          "checkpoint": str(CHECKPOINT.relative_to(ROOT)), "views": 8,
          "train_views": len(trainset), "width": WIDTH, "height": HEIGHT,
          "steps": TRAIN_STEPS, "capacity": LADDER_CAP,
          "isect_capacity": runner.isect_capacity(),
          "grad_dtype": lcfg.grad_dtype, "cutoff_mode": lcfg.cutoff_mode,
          "entropy_and_mask_gate": LADDER_GATE,
          "loss_first5": losses_l[:5], "loss_gated_first5": gated_l[:5],
          "loss_last5": gated_l[-5:],
          "psnr_before": before_l["psnr"], "psnr_after": after_l["psnr"],
          "ssim_before": before_l["ssim"], "ssim_after": after_l["ssim"],
          "step_ms_median": float(np.median([s_["ms"] for s_ in
                                             steps[:TRAIN_STEPS]])),
          "step_ms": [s_["ms"] for s_ in steps[:TRAIN_STEPS]], "bits": bits,
          "rd_term": [lcfg.rd_lambda * b_ for b_ in bits],
          "sim_aux": [s_["sim_aux"] for s_ in steps[:TRAIN_STEPS]],
          "n_isects": [s_["n_isects"] for s_ in steps[:TRAIN_STEPS]],
          "allocated_initial": n_init, "allocated": alloc,
          "allocated_expected": want_alloc, "events": runner.events,
          "skipped_steps": skipped_l,
          "sim_params_max_move": moved, "launches": ladder_launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in ladder_launches.items()},
          "view_check": ladder_check, "step_profiles": step_profiles_l,
          "train_seconds": ladder_s, "seconds": time.perf_counter() - t0})
    # the entropy_codec phase's factorized tables, on this run's models
    codec_runs.append(entropy_codec_run(runner, dev, "factorized",
                                        TRAIN_STEPS))
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)

    # 12. train_packed: the ladder's recipe with bf16 attribute rows and
    # the log scan (garden_benchmark.py --attr_dtype bf16 --log_composite)
    t0 = time.perf_counter()
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_packed_")
    pcfg = dataclasses.replace(lcfg, result_dir=stats_dir, attr_dtype="bf16",
                               log_composite=True)
    runner = Runner(pcfg, parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    sim = runner.compression_sim
    sim.entropy_steps = {k: LADDER_GATE for k in sim.entropy_steps}
    sim.ada_mask_start = LADDER_GATE
    before_p = runner.eval("before")
    steps = []
    train_step = runner.train_step
    runner.train_step = timed_step
    t1 = time.perf_counter()
    rv.reset_launch_counts()
    losses_p = runner.train(max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    packed_launches = dict(rv.LAUNCHES)
    packed_s = time.perf_counter() - t1
    after_p = runner.eval("after")
    packed_check = check_training_views(runner, steps[-1]["sh_degree"], errs,
                                        packed=True)
    gated_p = losses_p[LADDER_GATE + 1:]
    if not np.mean(gated_p[-5:]) < np.mean(gated_p[:5]):
        raise AssertionError(f"packed ladder loss did not fall: {losses_p}")
    if not after_p["psnr"] > before_p["psnr"]:
        raise AssertionError(f"packed ladder held-out PSNR did not rise: "
                             f"{before_p} -> {after_p}")
    if runner.skipped_steps:
        raise AssertionError(f"packed ladder skipped "
                             f"{runner.skipped_steps} steps")
    if min(packed_launches[k] for k in KERNELS_BENCH) < 1 or any(
            packed_launches[k] for k in F32_BRANCHES):
        raise AssertionError(f"the packed ladder did not take the precision "
                             f"branches: {packed_launches}")
    emit({"phase": "train_packed", "steps": TRAIN_STEPS,
          "capacity": LADDER_CAP, "isect_capacity": runner.isect_capacity(),
          "attr_dtype": pcfg.attr_dtype, "log_composite": pcfg.log_composite,
          "grad_dtype": pcfg.grad_dtype, "cutoff_mode": pcfg.cutoff_mode,
          "entropy_and_mask_gate": LADDER_GATE,
          "loss_first5": losses_p[:5], "loss_gated_first5": gated_p[:5],
          "loss_last5": gated_p[-5:],
          "psnr_before": before_p["psnr"], "psnr_after": after_p["psnr"],
          "ssim_before": before_p["ssim"], "ssim_after": after_p["ssim"],
          "step_ms_median": float(np.median([s_["ms"] for s_ in steps])),
          "step_ms": [s_["ms"] for s_ in steps],
          "n_isects": [s_["n_isects"] for s_ in steps],
          "skipped_steps": runner.skipped_steps, "launches": packed_launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in packed_launches.items()},
          "view_check": packed_check, "train_seconds": packed_s,
          "seconds": time.perf_counter() - t0})
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)

    # 13. train_2dgs_mcmc: Runner2DGS under MCMC on the same stand-in
    t0 = time.perf_counter()
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_2dgs_mcmc_")
    mcfg = Config2DGS(result_dir=stats_dir, strategy="mcmc",
                      mcmc_cap_max=LADDER_CAP, refine_start_iter=5,
                      refine_every=10, sh_degree_interval=5,
                      normal_start_iter=5, dist_start_iter=5)
    runner = Runner2DGS(mcfg, parser=parser, trainset=trainset,
                        valset=valset, device=dev)
    n_init2 = int(runner.strategy_state["allocated"].sum())
    steps = []
    train_step = runner.train_step
    runner.train_step = timed_step
    rv.reset_launch_counts()
    losses_m = runner.train(max_steps=MCMC_2DGS_STEPS, log_every=0)
    torch.cuda.synchronize()
    mcmc2_launches = dict(rv.LAUNCHES)
    refines_m = [e for e in runner.events if e["event"] == "refine"]
    gated_m = losses_m[mcfg.normal_start_iter + 1:]
    alloc_m = [e["allocated"] for e in refines_m]
    if not np.mean(gated_m[-5:]) < np.mean(gated_m[:5]):
        raise AssertionError(f"2DGS MCMC loss did not fall: {losses_m}")
    if runner.skipped_steps or len(refines_m) != 2 or \
            not n_init2 < alloc_m[0] < alloc_m[1]:
        raise AssertionError(f"2DGS MCMC skipped {runner.skipped_steps}, "
                             f"refines {refines_m}")
    if min(mcmc2_launches[k] for k in KERNELS_2DGS) < 1:
        raise AssertionError(f"a kernel did not launch in 2DGS MCMC: "
                             f"{mcmc2_launches}")
    emit({"phase": "train_2dgs_mcmc", "steps": MCMC_2DGS_STEPS,
          "capacity": LADDER_CAP, "loss_first5": losses_m[:5],
          "loss_gated_first5": gated_m[:5], "loss_last5": gated_m[-5:],
          "step_ms_median": float(np.median([s_["ms"] for s_ in steps])),
          "allocated_initial": n_init2, "allocated": alloc_m,
          "events": runner.events, "skipped_steps": runner.skipped_steps,
          "launches": mcmc2_launches, "seconds": time.perf_counter() - t0})
    del runner
    shutil.rmtree(stats_dir, ignore_errors=True)

    # The phases of the v1 backend and of B10/B11 come after every earlier
    # phase, so that those run in the conditions they ran in before.

    # 14. kernels_v1: B7 and B8 (rasterizer="pallas") on the kernels
    # phase's scene's scalar radii, tile 16 and 32, both cutoffs
    t0 = time.perf_counter()
    prep_v1_small = prepared(small, sw, sh, elliptical=False)
    cases_v1 = []
    for ts, cutoff, channels in [
            (ts, cutoff, None) for ts in (16, 32)
            for cutoff in ("exact", "soft")] + [
            (32, cutoff, ch) for ch in (64, 128)
            for cutoff in ("exact", "soft")]:
        v1 = V1Stages(rp, ti, prep_v1_small, sw, sh, ts, cutoff, 1 << 20,
                      channels=channels)
        res = v1.compare(errs)
        res.update(v1.compare_bwd(errs, seed=ts))
        cases_v1.append(dict(tile_size=ts, cutoff=cutoff,
                             channels=v1.cfg.channels,
                             n_isects=v1.n_isects, **res,
                             **v1.work(v1_ptxas)))
    del v1, prep_v1_small
    torch.cuda.synchronize()
    emit({"phase": "kernels_v1", "cases": cases_v1,
          "max_abs_err": {k: errs[k] for k in KERNELS_V1},
          "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL,
          "seconds": time.perf_counter() - t0})

    # 15. serve_v1: serve's views through the legacy v1 backend
    t0 = time.perf_counter()
    model = from_jax_splats(splats, device=dev)
    probe_v1, preps_v1 = [], []
    with torch.no_grad():
        means_s, quats_s, opac_s = model.means, model.quats, torch.sigmoid(
            model.opacities)
        scales_s = torch.exp(model.scales)
        outs = render_splats(model, cams, sh_degree=3,
                             isect_capacity=capacity)  # the fused images
        for cam in cams:
            vm_c = torch.as_tensor(np.linalg.inv(cam["camtoworld"])[None],
                                   device=dev)
            K_c = torch.as_tensor(cam["K"][None], device=dev)
            prep = project_and_shade(means_s, quats_s, scales_s, opac_s,
                                     model.sh_coeffs(), vm_c, K_c, WIDTH,
                                     HEIGHT, sh_degree=3, elliptical=False)
            probe_v1.append(int(rv.tile_counts(
                prep[1], prep[0], 16, -(-WIDTH // 16),
                -(-HEIGHT // 16))[3].sum()))
            if not preps_v1:
                preps_v1.append(prep)
    cap_v1 = int(1.2 * max(probe_v1))
    rv.reset_launch_counts()
    outs_v1 = render_splats(model, cams, sh_degree=3, isect_capacity=cap_v1,
                            rasterizer="pallas")
    torch.cuda.synchronize()
    serve_v1_launches = dict(rv.LAUNCHES)
    times_v1 = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        render_splats(model, cams, sh_degree=3, isect_capacity=cap_v1,
                      rasterizer="pallas")
        e1.record()
        e1.synchronize()
        times_v1.append(e0.elapsed_time(e1) / len(cams))
    n_isects_v1 = [int(m["n_isects"]) for _, _, m in outs_v1]
    if n_isects_v1 != probe_v1 or max(n_isects_v1) >= cap_v1:
        raise AssertionError(f"serve_v1 n_isects {n_isects_v1} vs probe "
                             f"{probe_v1}, capacity {cap_v1}")
    if not all(bool(torch.isfinite(img).all() and torch.isfinite(a).all())
               for img, a, _ in outs_v1):
        raise AssertionError("serve_v1 produced non-finite pixels")
    mean_alpha_v1 = float(torch.stack([a.mean() for _, a, _ in
                                       outs_v1]).mean())
    if not mean_alpha_v1 > 0.05:
        raise AssertionError(f"serve_v1 mean alpha {mean_alpha_v1} <= 0.05")
    if serve_v1_launches["raster_v1_fwd"] != len(cams) or any(
            serve_v1_launches[k] for k in FWD_KERNELS):
        raise AssertionError(f"serve_v1 did not render through B7 alone: "
                             f"{serve_v1_launches}")
    diff_vs_fused = [float((a[0] - b[0]).abs().mean())
                     for a, b in zip(outs_v1, outs)]
    view0_v1 = V1Stages(rp, ti, preps_v1[0], WIDTH, HEIGHT, 16,
                        rp.CUTOFF_MODE, cap_v1).compare(errs)
    emit({"phase": "serve_v1", "rasterizer": "pallas",
          "cutoff_mode": rp.CUTOFF_MODE, "views": len(cams), "width": WIDTH,
          "height": HEIGHT, "tile_size": 16, "isect_capacity": cap_v1,
          "n_isects": n_isects_v1, "ms_per_view": times_v1,
          "mean_alpha": mean_alpha_v1,
          "mean_abs_diff_vs_fused_exact": diff_vs_fused,
          "launches": serve_v1_launches, "view0_check": view0_v1,
          "seconds": time.perf_counter() - t0})
    del model, outs, outs_v1, preps_v1

    # 16. scene_1m_v1: scene_1m's scene through rasterizer="pallas", tile 16,
    # the soft cutoff (rasterize_pallas's default) and the exact one
    t0 = time.perf_counter()
    prep_1m_v1 = prepared(scene, WIDTH, HEIGHT, elliptical=False)
    cap_1m_v1 = _default_isect_capacity(1, N_1M)
    g = torch.Generator(device="cpu").manual_seed(9)
    ct_v1 = torch.randn((1, HEIGHT, WIDTH, 3), generator=g).to(dev)
    ca_v1 = torch.randn((1, HEIGHT, WIDTH, 1), generator=g).to(dev)
    leaves_v1 = [t.detach().clone().requires_grad_(True)
                 for t in (means, quats, scales, opac, colors)]

    def forward_v1():
        return rasterization(*leaves_v1, vm, Ks, WIDTH, HEIGHT, sh_degree=3,
                             tile_size=16, rasterizer="pallas", device=dev)

    def fwd_bwd_v1():
        for t in leaves_v1:
            t.grad = None
        img, alpha, _ = forward_v1()
        torch.autograd.backward([img, alpha], [ct_v1, ca_v1])

    runs_v1 = []
    for cutoff in ("soft", "exact"):
        rp.CUTOFF_MODE = cutoff
        try:
            v1 = V1Stages(rp, ti, prep_1m_v1, WIDTH, HEIGHT, 16, cutoff,
                          cap_1m_v1)
            check = v1.compare(errs)
            check.update(v1.compare_bwd(errs, seed=17))
            rv.reset_launch_counts()
            fwd_bwd_v1()
            torch.cuda.synchronize()
            launches = dict(rv.LAUNCHES)
            if launches["raster_v1_fwd"] != 1 or \
                    launches["raster_v1_bwd"] != 1 or \
                    launches["cumsum_rows"] != 1 or any(
                        launches[k] for k in KERNELS_3DGS):
                raise AssertionError(f"scene_1m_v1 fwd+bwd launches "
                                     f"{launches}")
            if not all(bool(torch.isfinite(t.grad).all())
                       for t in leaves_v1):
                raise AssertionError("scene_1m_v1 gradients not finite")
            with torch.no_grad():
                img, alpha, meta = forward_v1()
            if int(meta["n_isects"]) != v1.n_isects or \
                    v1.n_isects >= cap_1m_v1 or \
                    not bool(torch.isfinite(img).all()):
                raise AssertionError(f"scene_1m_v1 n_isects "
                                     f"{int(meta['n_isects'])} vs "
                                     f"{v1.n_isects}, capacity {cap_1m_v1}")
            fb_ms, fb_samples = median_ms(fwd_bwd_v1, 5)
            with torch.no_grad():
                f_ms, f_samples = median_ms(forward_v1, 5)
            k = v1.kernel_numbers()
            work = v1.work(v1_ptxas, tail=True)
            run = dict(
                cutoff=cutoff, n_isects=v1.n_isects,
                isect_capacity=cap_1m_v1, aligned_rows=v1.cfg.cap2,
                rows_in_runs=v1.chunks_in_runs * rp.K_CHUNK,
                chunks_in_runs=v1.chunks_in_runs,
                chunks_walked=v1.pair_counts["chunks"],
                fwd_ms=f_ms, fwd_ms_samples=f_samples, fwd_bwd_ms=fb_ms,
                fwd_bwd_ms_samples=fb_samples,
                mpix_per_s_fwd=WIDTH * HEIGHT / (f_ms * 1e-3) / 1e6,
                mpix_per_s_fwd_bwd=WIDTH * HEIGHT / (fb_ms * 1e-3) / 1e6,
                launches_per_fwd_bwd=launches, kernels=k, check=check,
                **work, order=v1.order_numbers(),
                sort_cancellation=v1.sort_cancellation(),
                cumsum_rows=v1.scan_numbers(errs),
                mean_alpha=float(alpha.mean()))
            if cutoff == "soft":
                run["profile"] = device_profile(fwd_bwd_v1)
                perf.update(k)
            runs_v1.append(run)
            del v1, img, alpha, meta
        finally:
            rp.CUTOFF_MODE = "soft"
    emit({"phase": "scene_1m_v1", "rasterizer": "pallas", "gaussians": N_1M,
          "width": WIDTH, "height": HEIGHT, "tile_size": 16,
          "runs": runs_v1, "seconds": time.perf_counter() - t0})
    del prep_1m_v1, leaves_v1

    # 17. train_v1: the train phase's run on the legacy v1 backend
    t0 = time.perf_counter()
    stats_dir = tempfile.mkdtemp(prefix="gsc_smoke_train_v1_")
    vcfg = dataclasses.replace(tcfg, result_dir=stats_dir,
                               rasterizer="pallas")
    runner = Runner(vcfg, parser=parser, trainset=trainset, valset=valset,
                    device=dev)
    before_v = runner.eval("before")
    steps = []
    train_step = runner.train_step
    runner.train_step = timed_step
    rv.reset_launch_counts()
    losses_v = runner.train(max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    v1_launches = dict(rv.LAUNCHES)
    after_v = runner.eval("after")
    v1_check = check_training_views_v1(runner, steps[-1]["sh_degree"], errs)
    prof_v = device_profile(lambda: train_step([v1_check["view"]], 3),
                            reps=1)
    refines_v = [e for e in runner.events if e["event"] == "refine"]
    if not np.mean(losses_v[-5:]) < np.mean(losses_v[:5]):
        raise AssertionError(f"train_v1 loss did not fall: {losses_v}")
    if not after_v["psnr"] > before_v["psnr"]:
        raise AssertionError(f"train_v1 held-out PSNR did not rise: "
                             f"{before_v} -> {after_v}")
    if runner.skipped_steps or len(refines_v) < 2:
        raise AssertionError(f"train_v1 skipped {runner.skipped_steps}, "
                             f"refines {refines_v}")
    if [v1_launches[k] for k in KERNELS_V1 + ("cumsum_rows",)] != \
            [TRAIN_STEPS] * 3 or any(v1_launches[k] for k in KERNELS_3DGS):
        raise AssertionError(f"train_v1 did not step through B7, B8 and "
                             f"B10 alone: {v1_launches}")
    emit({"phase": "train_v1", "rasterizer": vcfg.rasterizer,
          "cutoff_mode": rp.CUTOFF_MODE, "segred_mode": rp.SEGRED_MODE,
          "steps": TRAIN_STEPS, "capacity": runner.splats["means"].shape[0],
          "isect_capacity": runner.isect_capacity(),
          "tile_size": vcfg.tile_size,
          "loss_first5": losses_v[:5], "loss_last5": losses_v[-5:],
          "psnr_before": before_v["psnr"], "psnr_after": after_v["psnr"],
          "ssim_before": before_v["ssim"], "ssim_after": after_v["ssim"],
          "step_ms_median": float(np.median([s_["ms"] for s_ in steps])),
          "step_ms": [s_["ms"] for s_ in steps],
          "n_isects": [s_["n_isects"] for s_ in steps],
          "events": runner.events, "skipped_steps": runner.skipped_steps,
          "launches": v1_launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in v1_launches.items()},
          "view_check": v1_check, "step_profile_slowest_view": prof_v,
          "seconds": time.perf_counter() - t0})
    del runner, parser, trainset, valset
    shutil.rmtree(stats_dir, ignore_errors=True)


    # 18. cumsum_skel: B10 at [9, 2^23] (the JAX table's rows), and B11,
    # which lies on no path (as in the JAX package), on kernel_skel_bench's
    # four inputs
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(10)
    xc = torch.randn(CUMSUM_SHAPE, generator=g).to(dev)
    rv.reset_launch_counts()
    cs = rv.cumsum_rows(xc)
    skel_runs = skel.bench()
    torch.cuda.synchronize()
    cs_launches = dict(rv.LAUNCHES)
    if cs_launches["cumsum_rows"] < 1 or cs_launches["skel_composite"] < 1:
        raise AssertionError(f"cumsum_skel launches {cs_launches}")
    # against a float64 cumsum, within the kernel's own rounding bound
    # (rv.cumsum_rows_bound: its depth of additions, not the row's length),
    # on the signed input and on a non-negative one, where the bound is a
    # few ulps of every value and a wrong carry cannot hide in it
    xu = torch.rand(CUMSUM_SHAPE, generator=g).to(dev)
    cumsum_checks = {}
    for label, x_ in (("randn", xc), ("uniform", xu)):
        out_ = cs if x_ is xc else rv.cumsum_rows(x_)
        cdiff = (out_.double() - torch.cumsum(x_.double(), 1)).abs()
        cbound = rv.cumsum_rows_bound(x_)
        if not bool((cdiff <= cbound).all()):
            raise AssertionError(f"cumsum_rows ({label}) differs from the "
                                 f"float64 cumsum by more than its bound")
        cumsum_checks[label] = dict(
            max_abs_err=float(cdiff.max()),
            bound_share=float((cdiff / cbound).max()),
            bound_at_end=float(cbound[:, -1].max()))
        del out_, cdiff, cbound
    if not torch.equal(cs, rv.cumsum_rows(xc)):
        raise AssertionError("cumsum_rows differs between two runs")
    note_err(errs, ["cumsum_rows"], cumsum_checks["randn"]["max_abs_err"])
    R, L = CUMSUM_SHAPE
    perf["cumsum_rows"] = bound(dict(
        ms=cuda_ms(lambda: rv.cumsum_rows(xc), 10),
        plain_ms=cuda_ms(lambda: torch.cumsum(xc, 1), 10),
        library_ms=cuda_ms(lambda: torch.cumsum(xc, 1), 10),
        bytes=8 * R * L, ops=R * L))
    cumsum_res = dict(shape=list(CUMSUM_SHAPE), checks=cumsum_checks,
                      max_abs_err=cumsum_checks["randn"]["max_abs_err"],
                      **perf["cumsum_rows"])
    del xc, xu, cs
    # B11 against its plain version on the JAX script's four inputs and on
    # one whose tiles stop mid-run, twice for the same bits, with its work
    # in its layout (b11_work); no composited slot outside the cells its
    # test keeps. Its bound at term@24, on its candidate slots.
    T_s, avg_s, term_s, label_s = skel.INPUTS[1]
    skel_cases = [(label, skel.make, (T_, a_, t_))
                  for T_, a_, t_, label in skel.INPUTS]
    stop_label = f"{T_s} tiles x {avg_s} rows, stopping (make_stop)"
    skel_cases.append((stop_label, skel.make_stop, (T_s, avg_s)))
    b11_work = {}
    for label, make_, args in skel_cases:
        rows_c, starts_c, ends_c = (torch.as_tensor(a, device=dev)
                                    for a in make_(*args)[:3])
        out_c = skel.skel_composite(rows_c, starts_c, ends_c)
        same = torch.equal(out_c, skel.skel_composite(rows_c, starts_c,
                                                      ends_c))
        ref_c, counts_c = skel._skel_plain(rows_c, starts_c, ends_c,
                                           with_counts=True)
        err_c = float((out_c - ref_c).abs().max())
        b11_work[label] = dict(counts_c, max_abs_err=err_c,
                               cell_hit_share=counts_c["cell_hits"]
                               / max(1, counts_c["cell_tests"]),
                               composited_share=counts_c["composited"]
                               / max(1, counts_c["candidate"]))
        if not (math.isfinite(err_c) and err_c <= FWD_TOL):
            raise AssertionError(f"skel_composite ({label}) max abs err "
                                 f"{err_c} > {FWD_TOL}")
        if not same:
            raise AssertionError(f"skel_composite ({label}) differs "
                                 f"between two runs")
        if counts_c["missed"]:
            raise AssertionError(f"skel_composite ({label}): "
                                 f"{counts_c['missed']} composited slots "
                                 f"outside the cells its test keeps")
        note_err(errs, ["skel_composite"], err_c)
        if label == label_s:
            perf["skel_composite"] = tile_bound(dict(
                ms=[r["ms"] for r in skel_runs if r["label"] == label_s][0],
                plain_ms=once_ms(lambda: skel._skel_plain(
                    rows_c, starts_c, ends_c)),
                library_ms=None,
                bytes=4 * 9 * counts_c["columns"] + 8 * T_s
                + 4 * T_s * 256 * 3, input=label_s, counts=counts_c),
                counts_c, counts_c["candidate"], SKEL_OPS_EVALUATED,
                SKEL_OPS_COMPOSITED * counts_c["composited"])
        elif label == stop_label:
            b11_work[label]["ms"] = cuda_ms(lambda: skel.skel_composite(
                rows_c, starts_c, ends_c), 5)
        del rows_c, starts_c, ends_c, out_c, ref_c
    if b11_work[stop_label]["tiles_stopped"] == 0:
        raise AssertionError("skel_composite: make_stop's tiles never stop")
    emit({"phase": "cumsum_skel", "cumsum_rows": cumsum_res,
          "skel_composite_runs": skel_runs,
          "skel_composite_check": dict(perf["skel_composite"],
                                       max_abs_err=errs["skel_composite"]),
          "b11_work": b11_work,
          "launches": cs_launches, "seconds": time.perf_counter() - t0})

    # 19. garden_recipe: SelectiveAdam, the hash-grid entropy model,
    # checkpoints and the PNG codec (examples/garden_benchmark.py's path)
    recipe, recipe_launches = garden_recipe(dev, errs, perf, codec_runs)
    emit(recipe)

    # 20. colmap_trainer: the static trainer from a COLMAP scene through
    # simple_trainer's command line, with the per-image modules
    colmap, colmap_launches, rgb_ed_errs = colmap_trainer(dev, stages_for)
    emit(colmap)

    # 21. cameras: the ortho and fisheye cameras (and pinhole beside them)
    # through the fused path and the v1 forward on the serve checkpoint
    emit(cameras(dev, errs, stages_for))

    # 22. entropy_codec: run_compression("entropy_coding") of the train
    # (histograms), train_ladder (factorized) and garden_recipe (Gaussian
    # contexts) runners, made in those phases
    emit({"phase": "entropy_codec", "runs": codec_runs,
          "seconds": sum(r["phase_seconds"] for r in codec_runs)})
    # 23. dynamic: the dynamic/STG path (examples/dyn_benchmark.py's
    # recipe) at 120,000 slots and 9 feature channels, its legs and codecs
    dyn, dyn_launches, dyn_v1_launches, dyn_errs, dyn_rel = dynamic(
        dev, stages_for)
    emit(dyn)
    dyn_launches.update({k: dyn_v1_launches.get(k, 0.0)
                         for k in KERNELS_V1 + ("cumsum_rows",)})
    # 24. multigpu: the Gaussian-sharded mesh path, NCCL at world size 1
    # and gloo ranks on the one card
    mesh, mesh_launches, mesh_errs, mesh_rel = multigpu(dev)
    emit(mesh)
    chk = colmap["rgb_ed_check"]
    rgb_ed_rel = dict(pack_rows=0.0, expand=0.0, unpack_rows=0.0,
                      raster_fwd=chk["fwd_rel_err"],
                      raster_bwd=chk["bwd_rel_err_absgrad_0"],
                      segsum_rows=chk["segsum_rel_err"])

    # launches from each kernel's main path: the 3DGS training run, for the
    # 2DGS tile kernels the 2DGS training run, for the packed-pair branches
    # the ladder run, for the sorted table's precision branches one fwd+bwd
    # of bench_1m's bench.py configuration, for B5/B6's log branch one of
    # train_1m_2dgs's log leg
    main_path = dict(train_launches, raster_fwd_2dgs=train2_launches[
        "raster_fwd_2dgs"], raster_bwd_2dgs=train2_launches[
        "raster_bwd_2dgs"], raster_bwd_packed=ladder_launches[
        "raster_bwd_packed"], segsum_rows_packed=ladder_launches[
        "segsum_rows_packed"])
    for name in ("expand_packed", "raster_fwd_unpack", "raster_fwd_log",
                 "raster_bwd_unpack", "raster_bwd_log"):
        main_path[name] = bench_launches[name]
    for name in ("raster_fwd_2dgs_log", "raster_bwd_2dgs_log"):
        main_path[name] = launches2_log[name]
    # B6's absgrad rows: the probed fwd+bwd of train_1m_2dgs
    main_path["raster_bwd_2dgs_absgrad"] = launches2_abs[
        "raster_bwd_2dgs_absgrad"]
    for name in KERNELS_V1 + ("cumsum_rows",):  # the v1 training run
        main_path[name] = v1_launches[name]
    main_path["skel_composite"] = cs_launches["skel_composite"]
    main_path["selective_adam"] = recipe_launches["selective_adam"]
    emit({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name]["source"],
             replaces=KERNELS[name]["replaces"],
             launches=main_path[name], max_abs_err=errs[name],
             ms=perf[name]["ms"], plain_ms=perf[name]["plain_ms"],
             bound_ms=perf[name]["bound_ms"],
             bound_by=perf[name]["bound_by"],
             library_ms=perf[name]["library_ms"],
             **({"rgb_ed_max_abs_err": rgb_ed_errs[name],
                 "rgb_ed_rel_err": rgb_ed_rel[name],
                 "colmap_trainer_launches": colmap_launches[name]}
                if name in rgb_ed_errs else {}),
             **({"dynamic_launches": dyn_launches.get(name, 0.0),
                 "dynamic_max_abs_err": dyn_errs.get(name, 0.0),
                 **({"dynamic_rel_err": dyn_rel[name]}
                    if name in dyn_rel else {})}
                if name in DYN_KERNELS else {}),
             **({"mesh_launches": mesh_launches[name],
                 "mesh_max_abs_err": mesh_errs[name],
                 "mesh_rel_err": mesh_rel[name]}
                if name in KERNELS_3DGS else {}))
        for name in KERNELS
    ], "total_seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
