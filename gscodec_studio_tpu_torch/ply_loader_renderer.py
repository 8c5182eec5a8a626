"""Load .ply splats, render them and score them (port of
examples/ply_loader_renderer.py), on the CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.ply_loader_renderer --ply model.ply \
        [--ref_ply ref.ply] [--colmap_dir data/garden] [--save_images]

Renders a camera set (the COLMAP poses when ``--colmap_dir`` is given, else
a seeded orbit rig around the cloud), writes PNGs with ``--save_images``,
and given a second .ply (or directory of frame .plys) writes the GSC
metrics (RGB and YCbCr PSNR, luma SSIM and MS-SSIM) of each view to
out_dir/metrics.json, averaged.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def load_cameras(args, points):
    """The COLMAP scene's cameras (every view_stride-th) or an orbit rig."""
    from gscodec_studio_tpu_torch.utils.ply_render import orbit_cameras

    if args.colmap_dir:
        from gscodec_studio_tpu_torch.datasets.colmap import Parser

        p = Parser(args.colmap_dir, factor=args.factor)
        cams = []
        for i in range(0, len(p.camtoworlds), args.view_stride):
            cid = p.camera_ids[i]
            w, h = p.imsize_dict[cid]
            cams.append({"camtoworld": p.camtoworlds[i],
                         "K": p.Ks_dict[cid].astype(np.float32),
                         "width": w, "height": h})
        return cams
    return orbit_cameras(points, n_views=args.n_views, width=args.width,
                         height=args.height)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ply", required=True,
                   help=".ply file or directory of frame_*.ply")
    p.add_argument("--ref_ply", default=None,
                   help="optional reference .ply (file or dir) for metrics")
    p.add_argument("--out_dir", default="results/ply_render")
    p.add_argument("--colmap_dir", default=None)
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--view_stride", type=int, default=16)
    p.add_argument("--n_views", type=int, default=4)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None) -> dict:
    """Runs as the command line says; returns the averaged metrics."""
    args = build_parser().parse_args(argv)
    from gscodec_studio_tpu_torch.compression.png_io import write_png
    from gscodec_studio_tpu_torch.models.splats import from_jax_splats
    from gscodec_studio_tpu_torch.utils.gsc_metrics import gsc_metrics
    from gscodec_studio_tpu_torch.utils.ply import load_ply
    from gscodec_studio_tpu_torch.utils.ply_render import render_splats

    def load_frames(path):
        files = sorted(glob.glob(os.path.join(path, "*.ply"))) \
            if os.path.isdir(path) else [path]
        return [load_ply(f) for f in files]

    def render(frame):
        model = from_jax_splats(frame, device=args.device)
        return [img.cpu().numpy() for img, _, _ in render_splats(model,
                                                                  cams)]

    frames = load_frames(args.ply)
    cams = load_cameras(args, np.asarray(frames[0]["means"]))
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"{len(frames)} frame(s), {len(cams)} view(s)", flush=True)
    refs = load_frames(args.ref_ply) if args.ref_ply else None
    acc = {}
    for fi, fr in enumerate(frames):
        imgs = render(fr)
        if args.save_images:
            for vi, img in enumerate(imgs):
                write_png(os.path.join(args.out_dir,
                                       f"f{fi:04d}_v{vi:02d}.png"),
                          (img * 255).astype(np.uint8))
        if refs is not None:
            for r, d in zip(render(refs[fi]), imgs):
                for k, v in gsc_metrics(r, d, device=args.device).items():
                    acc.setdefault(k, []).append(v)
    out = {k: float(np.mean(v)) for k, v in acc.items()}
    if out:
        with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
