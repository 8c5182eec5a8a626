"""Load a checkpoint or .ply and render an orbit video's frames, or serve
the interactive HTTP viewer (port of examples/simple_viewer.py; viser is
absent, so ``--interactive`` serves utils/viewer.py's orbit viewer), on the
CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.simple_viewer --ckpt ckpt.npz \
        [--interactive --port 8080]

Offline, it writes output_dir/frame_<i>.png for ``--n_frames`` views on a
circle around the cloud (2.5x its 70th-percentile radius).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results/viewer_out")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--interactive", action="store_true",
                   help="serve the HTTP orbit viewer instead of rendering "
                   "frames")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def load_splats(args) -> dict:
    if args.ply:
        from gscodec_studio_tpu_torch.utils.ply import load_ply

        return load_ply(args.ply)
    if args.ckpt:
        with np.load(args.ckpt) as z:
            return {k.split("/", 1)[1]: z[k] for k in z.files
                    if k.startswith("splats/")}
    raise SystemExit("need --ply or --ckpt")


def make_renderer(splats: dict, sh_degree: int, device=None):
    """render(c2w [4, 4], K [3, 3], width, height) -> [H, W, 3] in [0, 1]
    of the splat dict (log scales, logit opacities)."""
    from gscodec_studio_tpu_torch.device import resolve_device
    from gscodec_studio_tpu_torch.rendering import rasterization

    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    means, quats = t(splats["means"]), t(splats["quats"])
    scales = torch.exp(t(splats["scales"]))
    opac = torch.sigmoid(t(splats["opacities"]))
    colors = torch.cat([t(splats["sh0"]), t(splats["shN"])], 1)

    def render(c2w, K, width, height):
        vm = np.linalg.inv(np.asarray(c2w, np.float32))[None]
        with torch.no_grad():
            img, _, _ = rasterization(
                means, quats, scales, opac, colors, vm,
                np.asarray(K, np.float32)[None], width, height,
                sh_degree=sh_degree, isect_capacity=4 << 20, device=dev)
        return torch.clamp(img[0], 0.0, 1.0)

    return render


def main(argv=None):
    """Runs as the command line says; offline, returns the frames' paths."""
    args = build_parser().parse_args(argv)
    from gscodec_studio_tpu_torch.compression.png_io import write_png
    from gscodec_studio_tpu_torch.datasets.traj import look_at

    splats = load_splats(args)
    render = make_renderer(splats, args.sh_degree, args.device)
    means = np.asarray(splats["means"])
    center = means.mean(axis=0)
    r = float(np.percentile(np.linalg.norm(means - center, axis=-1), 70))
    if args.interactive:
        from gscodec_studio_tpu_torch.utils.viewer import SplatViewer

        SplatViewer(render, width=args.width, height=args.height,
                    center=center, radius=2.5 * r).serve(args.port)
        return []
    f = 1.1 * args.width
    K = np.array([[f, 0, args.width / 2], [0, f, args.height / 2],
                  [0, 0, 1]], np.float32)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i, th in enumerate(np.linspace(0, 2 * np.pi, args.n_frames,
                                       endpoint=False)):
        eye = center + 2.5 * r * np.array([np.cos(th), -0.3, np.sin(th)])
        img = render(look_at(eye, center), K, args.width, args.height)
        paths.append(os.path.join(args.output_dir, f"frame_{i:04d}.png"))
        write_png(paths[-1], (img.cpu().numpy() * 255).astype(np.uint8))
    print(f"wrote {len(paths)} frames to {args.output_dir}", flush=True)
    return paths


if __name__ == "__main__":
    main()
