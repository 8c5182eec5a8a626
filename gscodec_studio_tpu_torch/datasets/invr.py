"""INVR-style multiview video (port of gscodec_studio_tpu/datasets/invr.py):
Blender transforms-JSON cameras with per-frame timestamped images.

Layout: <data_dir>/transforms_<split>.json (else transforms.json) with
frames {file_path, transform_matrix, time (optional)}; intrinsics from
fl_x/fl_y or camera_angle_x; optional points3d.npy for the initial points.
PNGs are read by the port's own reader (compression/png_io.py), other
formats through imageio where it imports; a factor > 1 keeps every
factor-th pixel, as the JAX package does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from gscodec_studio_tpu_torch.compression.png_io import read_png

# Blender (OpenGL) -> OpenCV camera axes.
_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def read_image_raw(path: str) -> np.ndarray:
    """The image's uint8 array as stored (gray [H, W], else [H, W, C] with
    any alpha): PNGs by png_io, other formats through imageio."""
    if os.path.splitext(path)[1].lower() == ".png":
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(f"{path}: only PNG is read without imageio, "
                           f"which does not import here") from e
    return np.asarray(imageio.imread(path))


class INVRParser:
    def __init__(self, data_dir: str, split: str = "train",
                 factor: int = 1):
        self.data_dir = data_dir
        path = os.path.join(data_dir, f"transforms_{split}.json")
        if not os.path.exists(path):
            path = os.path.join(data_dir, "transforms.json")
        with open(path) as f:
            meta = json.load(f)
        self.frames: List[Dict] = []
        for fr in meta["frames"]:
            c2w = np.asarray(fr["transform_matrix"], np.float64) @ _FLIP
            self.frames.append({"file_path": fr["file_path"],
                                "camtoworld": c2w.astype(np.float32),
                                "timestamp": float(fr.get("time", 0.0))})
        self.meta = meta
        self.factor = factor
        h, w = read_image_raw(self._img_path(self.frames[0])).shape[:2]
        if "fl_x" in meta:
            fx, fy = meta["fl_x"], meta.get("fl_y", meta["fl_x"])
        else:
            fx = fy = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        self.K = np.array([[fx / factor, 0, w / 2 / factor],
                           [0, fy / factor, h / 2 / factor],
                           [0, 0, 1]], np.float32)
        self.width, self.height = w // factor, h // factor
        pts_path = os.path.join(data_dir, "points3d.npy")
        if os.path.exists(pts_path):
            self.points = np.load(pts_path).astype(np.float32)
            self.points_rgb = np.full((len(self.points), 3), 127, np.uint8)
        else:
            self.points = None
            self.points_rgb = None

    def _img_path(self, fr) -> str:
        p = fr["file_path"]
        if not os.path.splitext(p)[1]:
            p = p + ".png"
        return os.path.join(self.data_dir, p)


class INVRDataset:
    def __init__(self, parser: INVRParser):
        self.parser = parser

    def __len__(self):
        return len(self.parser.frames)

    def __getitem__(self, i: int) -> Dict:
        fr = self.parser.frames[i]
        img = read_image_raw(self.parser._img_path(fr))
        if img.shape[-1] == 4:  # alpha composited on white
            a = img[..., 3:4] / 255.0
            img = img[..., :3] * a + 255 * (1 - a)
        f = self.parser.factor
        if f > 1:
            img = img[::f, ::f]
        return {"K": self.parser.K, "camtoworld": fr["camtoworld"],
                "image": np.asarray(img, np.float32) / 255.0,
                "timestamp": fr["timestamp"], "image_id": i}
