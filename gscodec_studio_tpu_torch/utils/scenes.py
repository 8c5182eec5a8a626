"""Scenes without a dataset: the 1M-Gaussian synthetic scene (the port's
own copy of bench.py:make_scene) and the training stand-in built from a
trained checkpoint (the method of examples/garden_benchmark.py)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

LIVE_OPACITY = 0.005  # models.splats.num_live's threshold


def make_scene(n: int = 1_000_000, width: int = 1297, height: int = 840,
               seed: int = 0):
    """Garden-like synthetic scene: points clustered in a disk with a
    realistic opacity/scale mix, SH degree 3, one camera 6 units back.
    Returns numpy (means, quats, scales, opacities, colors [n,16,3],
    viewmats [1,4,4], Ks [1,3,3]); scales and opacities are linear."""
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.standard_normal(n) * 2.5
    means[:, 1] = rng.standard_normal(n) * 1.5
    means[:, 2] = rng.standard_normal(n) * 2.5
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-4.6, 0.7, (n, 3))).astype(np.float32)
    opacities = (rng.beta(0.7, 1.2, n)).astype(np.float32)
    sh0 = (rng.random((n, 1, 3)) - 0.5).astype(np.float32)
    shN = (0.1 * rng.standard_normal((n, 15, 3))).astype(np.float32)
    colors = np.concatenate([sh0, shN], axis=1)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, 3] = [0, 0, 6.0]
    f = 1100.0
    Ks = np.array(
        [[[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]], np.float32
    )
    return means, quats, scales, opacities, colors, viewmat[None], Ks


class StandInParser:
    """The training stand-in's scene: target views rendered from a trained
    checkpoint, and its point cloud as the initialisation (the means of the
    checkpoint's live Gaussians, coloured by clip(sh_to_rgb(sh0), 0, 1)),
    as an SfM parser gives them. ``scene_scale`` is 1.1 x the largest
    distance of a camera centre from their mean, the JAX package's COLMAP
    Parser rule."""

    def __init__(self, points, points_rgb, cameras: List[dict],
                 images: List[torch.Tensor]):
        self.points = points
        self.points_rgb = points_rgb  # 0..255
        self.camtoworlds = np.stack([c["camtoworld"] for c in cameras])
        self.Ks = [np.asarray(c["K"], np.float32) for c in cameras]
        self.images = images
        locs = self.camtoworlds[:, :3, 3]
        self.scene_scale = float(
            np.max(np.linalg.norm(locs - locs.mean(axis=0), axis=1)) * 1.1)


class ViewDataset:
    """Views ``indices`` of a StandInParser as dicts of camtoworld, K and
    image [H, W, 3]."""

    def __init__(self, parser: StandInParser, indices):
        self.parser = parser
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        j = self.indices[i]
        p = self.parser
        return {"camtoworld": p.camtoworlds[j], "K": p.Ks[j],
                "image": p.images[j], "image_id": j}


def checkpoint_stand_in(path, n_views: int = 8, width: int = 1297,
                        height: int = 840, held_out: int = 1,
                        isect_capacity: int = 1 << 20,
                        device: DeviceLike = None):
    """(parser, trainset, valset) of the training stand-in: the checkpoint
    (the JAX package's npz splat dict) rendered from ``n_views`` orbit
    cameras with the port's forward as the targets, the last ``held_out``
    views for validation. The point cloud holds the live Gaussians only
    (opacity above models.splats.num_live's 0.005): a trained checkpoint's
    pruned and dead slots keep stale means, up to kilometres from the
    scene, which are no scene points and would get k-NN scales to match."""
    from gscodec_studio_tpu_torch.models.splats import (from_jax_splats,
                                                        sh_to_rgb)
    from gscodec_studio_tpu_torch.utils.ply_render import (orbit_cameras,
                                                           render_splats)

    dev = resolve_device(device)
    with np.load(path) as z:
        splats = {k: z[k] for k in z.files}
    model = from_jax_splats(splats, device=dev)
    cams = orbit_cameras(splats["means"], n_views=n_views, width=width,
                         height=height)
    outs = render_splats(model, cams, isect_capacity=isect_capacity)
    cap = -(-isect_capacity // 4096) * 4096
    for _, _, meta in outs:
        if int(meta["n_isects"][0]) >= cap:
            raise ValueError("a target view filled the intersection "
                             "capacity; raise isect_capacity")
    opacity = 1.0 / (1.0 + np.exp(-np.asarray(splats["opacities"],
                                              np.float64).reshape(-1)))
    live = opacity > LIVE_OPACITY
    sh0 = np.asarray(splats["sh0"], np.float32).reshape(-1, 3)[live]
    rgb = np.clip(sh_to_rgb(sh0), 0.0, 1.0) * 255.0
    parser = StandInParser(np.asarray(splats["means"], np.float32)[live], rgb,
                           cams, [img for img, _, _ in outs])
    n_train = n_views - held_out
    return (parser, ViewDataset(parser, range(n_train)),
            ViewDataset(parser, range(n_train, n_views)))
