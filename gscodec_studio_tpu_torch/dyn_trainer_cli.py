"""Dynamic-splat training on INVR (Blender-JSON multiview video), Neural3D
or Technicolor (per-frame COLMAP) (port of examples/dyn_trainer_cli.py),
on the CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.dyn_trainer_cli --data-dir <dir> \
        --data-type invr --strategy modified_stg --compression-sim

Trains temporal splats (training/dyn_trainer.py), evaluates, writes
result_dir/stats.json, with ``--export-frames N`` N per-frame plys under
result_dir/ply_seq/ for the sequence codec, and with ``--eval-video`` the
first validation view over time (eval_view0.mp4, or the folder eval_view0
of PNG frames where no mp4 writer imports).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gscodec_studio_tpu_torch.training.dyn_trainer import (DynConfig,
                                                           DynRunner)
from gscodec_studio_tpu_torch.utils.ply import save_ply


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--data-type", default="invr",
                   choices=["invr", "n3d", "technicolor"])
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--duration", type=int, default=50)
    p.add_argument("--result-dir", default="results/dyn")
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--max-steps", type=int, default=30_000)
    p.add_argument("--cap-max", type=int, default=200_000)
    p.add_argument("--strategy", default="mcmc",
                   choices=["mcmc", "default", "stg", "modified_stg"])
    p.add_argument("--color-mode", default="sandwich",
                   choices=["rgb", "linear", "sandwich"])
    p.add_argument("--compression-sim", action="store_true")
    p.add_argument("--entropy-model-opt", action="store_true")
    p.add_argument("--rd-lambda", type=float, default=1e-2)
    p.add_argument("--init-points", type=int, default=100_000)
    p.add_argument("--export-frames", type=int, default=0,
                   help="per-frame .ply count for the sequence codec")
    p.add_argument("--eval-video", action="store_true")
    p.add_argument("--eval-video-frames", type=int, default=60)
    p.add_argument("--rasterizer", default="fused",
                   choices=["fused", "pallas", "reference"])
    p.add_argument("--steps-per-dispatch", type=int, default=10)
    p.add_argument("--isect-capacity", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def load_data(args):
    """(train parser, trainset, valset) of the data directory."""
    if args.data_type in ("n3d", "technicolor"):
        from gscodec_studio_tpu_torch.datasets.stg_readers import (
            STGDataset, STGParser)

        kw = dict(dataset_type=args.data_type, start=args.start_frame,
                  duration=args.duration, factor=args.factor)
        train_parser = STGParser(args.data_dir, split="train", **kw)
        val_parser = STGParser(args.data_dir, split="test", **kw)
        return (train_parser, STGDataset(train_parser),
                STGDataset(val_parser if val_parser.views else train_parser))
    from gscodec_studio_tpu_torch.datasets.invr import (INVRDataset,
                                                        INVRParser)

    train_parser = INVRParser(args.data_dir, "train", factor=args.factor)
    try:
        val_parser = INVRParser(args.data_dir, "val", factor=args.factor)
    except FileNotFoundError:
        val_parser = train_parser
    return train_parser, INVRDataset(train_parser), INVRDataset(val_parser)


def initial_points(train_parser, n: int):
    """The parser's points and colours in [0, 1], or, where the dataset
    has none, ``n`` uniform points in a box around the cameras with
    uniform colours (the JAX command line's numpy draws)."""
    if train_parser.points is not None:
        return train_parser.points, train_parser.points_rgb / 255.0
    rng = np.random.default_rng(0)
    frames = getattr(train_parser, "frames", None) or train_parser.views
    centers = np.stack([f["camtoworld"][:3, 3] for f in frames])
    c0 = centers.mean(axis=0)
    r = max(np.linalg.norm(centers - c0, axis=1).mean() * 2.0, 1.0)
    points = (c0 + r * (rng.random((n, 3)) * 2 - 1)).astype(np.float32)
    return points, rng.random((n, 3)).astype(np.float32)


def main(argv=None) -> DynRunner:
    """Trains as the command line ``argv`` (sys.argv[1:] when None) says;
    returns the runner."""
    args = build_parser().parse_args(argv)
    train_parser, trainset, valset = load_data(args)
    points, rgbs = initial_points(train_parser, args.init_points)
    cfg = DynConfig(
        result_dir=args.result_dir, max_steps=args.max_steps,
        strategy=args.strategy, mcmc_cap_max=args.cap_max,
        capacity=args.cap_max, color_mode=args.color_mode,
        compression_sim=args.compression_sim,
        entropy_model_opt=args.entropy_model_opt, rd_lambda=args.rd_lambda,
        rasterizer=args.rasterizer,
        steps_per_dispatch=args.steps_per_dispatch,
        isect_capacity=args.isect_capacity)
    runner = DynRunner(cfg, points, rgbs, trainset, valset, scene_scale=1.0,
                       device=args.device)
    t0 = time.time()
    losses = runner.train(log_every=500)
    metrics = runner.eval()
    out = {"steps": args.max_steps, "secs": round(time.time() - t0, 1),
           "final_loss": round(float(np.mean(losses[-50:])), 4),
           **{k: round(v, 3) for k, v in metrics.items()}}
    print(json.dumps(out), flush=True)
    os.makedirs(args.result_dir, exist_ok=True)
    with open(os.path.join(args.result_dir, "stats.json"), "w") as f:
        json.dump(out, f)

    if args.export_frames:
        frames = runner.export_frames(np.linspace(0.0, 1.0,
                                                  args.export_frames))
        ply_dir = os.path.join(args.result_dir, "ply_seq")
        os.makedirs(ply_dir, exist_ok=True)
        for i, fr in enumerate(frames):
            save_ply(os.path.join(ply_dir, f"frame_{i:04d}.ply"), fr)
        print(f"exported {len(frames)} frames to {ply_dir}", flush=True)

    if args.eval_video:
        d = valset[0]
        h, w = np.asarray(d["image"]).shape[:2]
        path = runner.render_view_video(
            d["camtoworld"], d["K"], w, h,
            np.linspace(0, 1, args.eval_video_frames),
            os.path.join(args.result_dir, "eval_view0.mp4"))
        print(f"eval video: {path}", flush=True)
    return runner


if __name__ == "__main__":
    main()
