"""The MPEG video-anchor codec command line (port of
examples/compress_ply_sequence.py): a tracked .ply sequence through the
sequence codec at the rate points rp0-rp3, decoded to decoded/*.ply and,
with ``--eval_views``, the decoded frames rendered beside the source ones
on orbit cameras (utils/ply_render.sequence_metrics), on the CUDA card
unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.compress_ply_sequence \
        --ply_dir results/dyn_stand_in/frames --rate_points rp0 rp2

Each rate point writes output_dir/<rp>/ (the bitstream, meta.json,
decoded/ and stats.json: qp, bytes, bytes a frame, the backend, each
attribute's bits and the metrics).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np

from gscodec_studio_tpu_torch.compression.png_compression import (
    compressed_size)
from gscodec_studio_tpu_torch.compression.seq_codec import SeqCodec
from gscodec_studio_tpu_torch.utils.ply import load_ply, save_ply

RATE_POINTS = {"rp0": 30, "rp1": 25, "rp2": 20, "rp3": 15}  # qp


def main(argv=None) -> list:
    """Runs the ladder as ``argv`` (sys.argv[1:] when None) says; returns
    each rate point's stats."""
    p = argparse.ArgumentParser()
    p.add_argument("--ply_dir", required=True,
                   help="directory of frame_*.ply (tracked sequence)")
    p.add_argument("--output_dir", default="results/ply_seq")
    p.add_argument("--rate_points", nargs="*", default=["rp2"])
    p.add_argument("--all_intra", action="store_true")
    p.add_argument("--eval_views", type=int, default=4,
                   help="orbit views of the decoded-against-source metrics"
                   " (0: none)")
    p.add_argument("--eval_width", type=int, default=640)
    p.add_argument("--eval_height", type=int, default=480)
    p.add_argument("--eval_frame_stride", type=int, default=1)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "hevc", "pngseq"])
    p.add_argument("--device", default=None,
                   help="torch device of the renders (default: the CUDA "
                   "card)")
    args = p.parse_args(argv)

    plys = sorted(glob.glob(os.path.join(args.ply_dir, "*.ply")))
    if not plys:
        raise SystemExit(f"no .ply files in {args.ply_dir}")
    frames = [load_ply(f) for f in plys]
    print(f"loaded {len(frames)} frames, {len(frames[0]['means'])} splats",
          flush=True)
    rows = []
    for rp in args.rate_points:
        qp = RATE_POINTS[rp]
        out = os.path.join(args.output_dir, rp)
        codec = SeqCodec(backend=args.backend, qp=qp,
                         all_intra=args.all_intra)
        # a clean folder: compressed_size measures this run's stream only
        if os.path.isdir(out):
            shutil.rmtree(out)
        codec.compress(out, frames)
        size = compressed_size(out)
        decoded = codec.decompress(out)
        dec_dir = os.path.join(out, "decoded")
        os.makedirs(dec_dir, exist_ok=True)
        for i, fr in enumerate(decoded):
            n = len(fr["means"])
            save_ply(os.path.join(dec_dir, f"frame_{i:04d}.ply"), {
                "means": fr["means"], "scales": fr["scales"],
                "quats": fr["quats"],
                "opacities": fr["opacities"].reshape(-1),
                "sh0": fr.get("sh0", np.zeros((n, 1, 3))).reshape(n, 1, 3),
                "shN": fr.get("shN", np.zeros((n, 0, 3))).reshape(n, -1, 3),
            })
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        stats = {"rate_point": rp, "qp": qp, "bytes": size,
                 "bytes_per_frame": size / len(frames),
                 "backend": meta["backend"],
                 "bits": {k: m["bits"] for k, m in meta["attrs"].items()
                          if "bits" in m}}
        if args.eval_views > 0:
            from gscodec_studio_tpu_torch.utils.ply_render import (
                orbit_cameras, sequence_metrics)

            cams = orbit_cameras(np.asarray(frames[0]["means"]),
                                 n_views=args.eval_views,
                                 width=args.eval_width,
                                 height=args.eval_height)
            st = args.eval_frame_stride
            stats.update(sequence_metrics(frames[::st], decoded[::st], cams,
                                          device=args.device))
        with open(os.path.join(out, "stats.json"), "w") as f:
            json.dump(stats, f)
        print(json.dumps(stats), flush=True)
        rows.append(stats)
    return rows


if __name__ == "__main__":
    main()
