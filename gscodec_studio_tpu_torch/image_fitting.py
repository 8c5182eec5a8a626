"""The 2D toy: fit N Gaussians to one image (port of
examples/image_fitting.py) through rendering.rasterization and Adam, on
the CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.image_fitting [--img_path x.png] \
        [--num_points 10000] [--iterations 1000]

Without ``--img_path`` the target is a colour gradient. The Gaussians
start from numpy's seed-0 draws, the JAX script's; Adam is torch's at
``--lr`` (optax's defaults: betas 0.9, 0.999, eps 1e-8). Writes the fit to
``--save_path`` as a PNG.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--img_path", type=str, default=None,
                   help="a PNG target (default: a colour gradient)")
    p.add_argument("--num_points", type=int, default=10_000)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--save_path", type=str, default="results/image_fit.png")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def initial_params(N: int, W: int, H: int):
    """The JAX script's seed-0 initialisation, and the focal length."""
    rng = np.random.default_rng(0)
    fov_x = np.pi / 2
    f = 0.5 * W / np.tan(0.5 * fov_x)
    extent = np.array([2 * np.tan(fov_x / 2) * 8, 2 * H / W * 8, 1],
                      np.float32)
    params = {
        "means": (rng.random((N, 3), np.float32) - 0.5) * extent
        + np.array([0, 0, 8.0], np.float32),
        "scales": np.log(0.05 + 0.1 * rng.random((N, 3), np.float32) * 8),
        "quats": rng.standard_normal((N, 4)).astype(np.float32),
        "opacities": np.zeros(N, np.float32),
        "colors": rng.random((N, 3)).astype(np.float32),
    }
    return params, f


def main(argv=None) -> dict:
    """Fits as the command line says; returns the first and last MSE and
    the PSNR."""
    args = build_parser().parse_args(argv)
    from gscodec_studio_tpu_torch.compression.png_io import (read_png,
                                                           write_png)
    from gscodec_studio_tpu_torch.device import resolve_device
    from gscodec_studio_tpu_torch.rendering import rasterization

    dev = resolve_device(args.device)
    if args.img_path:
        target = (read_png(args.img_path)[..., :3] / 255.0).astype(
            np.float32)
        H, W = target.shape[:2]
    else:
        H, W = args.height, args.width
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        target = np.stack([yy / H, xx / W, (1 - yy / H) * (xx / W)],
                          -1).astype(np.float32)
    tgt = torch.as_tensor(target, device=dev)[None]
    init, f = initial_params(args.num_points, W, H)
    params = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in init.items()}
    viewmats = torch.eye(4, device=dev)[None]
    Ks = torch.tensor([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                      dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(params.values(), lr=args.lr, eps=1e-8)

    def render():
        img, _, _ = rasterization(
            params["means"], params["quats"], torch.exp(params["scales"]),
            torch.sigmoid(params["opacities"]),
            torch.sigmoid(params["colors"]), viewmats, Ks, W, H,
            isect_capacity=1 << 20, device=dev)
        return img

    t0 = time.time()
    losses = []
    for it in range(args.iterations):
        loss = torch.mean((render() - tgt) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % 100 == 0:
            print(f"iter {it}: mse {losses[-1]:.5f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    with torch.no_grad():
        img = render()[0]
    write_png(args.save_path,
              (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
    psnr = -10 * np.log10(losses[-1])
    print("PSNR:", psnr, "->", args.save_path, flush=True)
    return {"mse_first": losses[0], "mse_last": losses[-1], "psnr": psnr}


if __name__ == "__main__":
    main()
