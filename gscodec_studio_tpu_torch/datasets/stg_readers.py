"""SpacetimeGaussian dataset readers, Neural3D (N3D) and Technicolor (port
of gscodec_studio_tpu/datasets/stg_readers.py). Both store a multiview
video as per-frame COLMAP workspaces:

    scene/
      poses_bounds.npy            (N3D only: LLFF poses + depth bounds)
      colmap_<t>/
        sparse/0/{cameras,images,points3D}.{bin|txt}   (t = start frame)
        images/cam00.png ... camNN.png

The poses are shared across frames (only colmap_<start> carries a sparse
model); frame t's images lie under colmap_<t>/images/. N3D takes one K
from poses_bounds.npy and holds out the views in ``test_view_ids``;
Technicolor takes each camera's PINHOLE intrinsics and holds out every
``llffhold``-th camera. Timestamps are (t - start) / duration. Images go
through datasets/invr.read_image_raw (PNGs by the port's reader).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence

import numpy as np

from gscodec_studio_tpu_torch.datasets.colmap_io import (qvec_to_rotmat,
                                                         read_model)
from gscodec_studio_tpu_torch.datasets.invr import read_image_raw


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


class STGParser:
    """An N3D/Technicolor scene as a flat (camera x frame) view list and
    the SfM initial points."""

    def __init__(self, data_dir: str, dataset_type: str = "n3d",
                 start: int = 0, duration: int = 50, split: str = "train",
                 llffhold: int = 8, test_view_ids: Sequence[int] = (0,),
                 factor: int = 1):
        if dataset_type not in ("n3d", "technicolor"):
            raise ValueError(f"unknown dataset_type {dataset_type!r}")
        self.data_dir = data_dir
        self.dataset_type = dataset_type
        self.factor = factor
        base = os.path.join(data_dir, f"colmap_{start}")
        cams, imgs, pts = read_model(os.path.join(base, "sparse", "0"))
        self.points = pts[0].astype(np.float32)
        self.points_rgb, self.points_err = pts[1], pts[2]

        K_global = None
        self.near, self.far = 0.01, 100.0
        if dataset_type == "n3d":
            pb = np.load(os.path.join(data_dir, "poses_bounds.npy"))
            poses = pb[:, :15].reshape(-1, 3, 5)
            bounds = pb[:, -2:]
            self.near = float(bounds.min() * 0.95)
            self.far = float(bounds.max() * 1.05)
            H, W, focal = poses[0, :, -1]
            K_global = np.array([[focal / factor, 0.0, W / 2.0 / factor],
                                 [0.0, focal / factor, H / 2.0 / factor],
                                 [0.0, 0.0, 1.0]], np.float32)

        # natural name order (cam2 before cam10)
        by_name = sorted(imgs.values(), key=lambda im: _natural_key(im.name))
        test_set = set()
        for ci, im in enumerate(by_name):
            if dataset_type == "technicolor":
                if ci % llffhold == 0:
                    test_set.add(im.name)
            elif ci in test_view_ids:
                test_set.add(im.name)

        self.views: List[Dict] = []
        for im in by_name:
            if (split == "train") == (im.name in test_set):
                continue
            cam = cams[im.camera_id]
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = qvec_to_rotmat(np.asarray(im.qvec))
            w2c[:3, 3] = np.asarray(im.tvec, np.float32)
            c2w = np.linalg.inv(w2c).astype(np.float32)
            if K_global is not None:
                K = K_global
            else:  # the camera's own principal point
                p = np.asarray(cam.params, np.float64)
                if cam.model == "SIMPLE_PINHOLE":
                    fx = fy = p[0]
                    cx, cy = p[1], p[2]
                else:
                    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
                K = np.array([[fx / factor, 0.0, cx / factor],
                              [0.0, fy / factor, cy / factor],
                              [0.0, 0.0, 1.0]], np.float32)
            width = int(cam.width) // factor
            height = int(cam.height) // factor
            for t in range(start, start + duration):
                self.views.append({
                    "camtoworld": c2w, "K": K,
                    "image_path": os.path.join(data_dir, f"colmap_{t}",
                                               "images",
                                               os.path.basename(im.name)),
                    "timestamp": (t - start) / float(duration),
                    "width": width, "height": height, "cam_name": im.name,
                })
        centers = np.stack([v["camtoworld"][:3, 3] for v in self.views]) \
            if self.views else np.zeros((1, 3), np.float32)
        center = centers.mean(axis=0)
        self.scene_scale = float(
            np.linalg.norm(centers - center, axis=1).max() * 1.1 + 1e-6)


class STGDataset:
    """The views of an STGParser, images read on access."""

    def __init__(self, parser: STGParser):
        self.parser = parser

    def __len__(self):
        return len(self.parser.views)

    def __getitem__(self, i: int) -> Dict:
        v = self.parser.views[i]
        img = np.asarray(read_image_raw(v["image_path"]), np.float32) / 255.0
        f = self.parser.factor
        if f > 1:
            img = img[::f, ::f]
        return {"K": v["K"], "camtoworld": v["camtoworld"],
                "image": img[..., :3], "timestamp": np.float32(v["timestamp"]),
                "image_id": i}
