"""Reader of the standard COLMAP sparse-reconstruction formats (cameras,
images and points3D, .bin and .txt): the port's own copy of
gscodec_studio_tpu/datasets/colmap_io.py, numpy only.

Format documented at colmap.github.io/format.html.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    point3d_ids: "np.ndarray | None" = None  # [n2d] i64, -1 = no track


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(fmt, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, width, height = _read("<iiQQ", f)
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_}d", f))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_bin(path: str, load_points2d: bool = False
                    ) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            (image_id,) = _read("<i", f)
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            (camera_id,) = _read("<i", f)
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read("<Q", f)
            p3d = None
            if load_points2d:
                # 2D points are (x f64, y f64, point3D_id i64) records
                rec = np.frombuffer(
                    f.read(n2d * 24),
                    dtype=np.dtype([("x", "<f8"), ("y", "<f8"),
                                    ("id", "<i8")]),
                )
                p3d = rec["id"].astype(np.int64)
            else:
                f.seek(n2d * 24, os.SEEK_CUR)
            imgs[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), p3d
            )
    return imgs


def read_points3d_bin(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, err [N], ids [N] i64)."""
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        ids = np.empty(n, np.int64)
        for i in range(n):
            data = _read("<Q3d3Bd", f)
            ids[i] = data[0]
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read("<Q", f)
            f.seek(track_len * 8, os.SEEK_CUR)
    return xyz, rgb, err, ids


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id = int(parts[0])
        cams[cam_id] = ColmapCamera(
            cam_id, parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cams


def read_images_txt(path: str, load_points2d: bool = False
                    ) -> Dict[int, ColmapImage]:
    imgs = {}
    lines = [
        l.strip() for l in open(path) if l.strip() and not l.startswith("#")
    ]
    for meta, pts_line in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        p3d = None
        if load_points2d:
            trip = pts_line.split()
            p3d = np.array(trip[2::3], np.int64) if trip else np.empty(
                0, np.int64
            )
        imgs[image_id] = ColmapImage(
            image_id, qvec, tvec, int(parts[8]), parts[9], p3d
        )
    return imgs


def read_points3d_txt(path: str):
    xyz, rgb, err, ids = [], [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        ids.append(int(parts[0]))
        xyz.append([float(p) for p in parts[1:4]])
        rgb.append([int(p) for p in parts[4:7]])
        err.append(float(parts[7]))
    return (
        np.array(xyz, np.float64).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err),
        np.array(ids, np.int64),
    )


def read_model(sparse_dir: str, load_points2d: bool = False):
    """Load (cameras, images, (xyz, rgb, err, ids)) from a COLMAP sparse
    dir (bin or txt). ``load_points2d`` also parses each image's 2D-point
    tracks (point3D ids) for depth supervision."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(
            os.path.join(sparse_dir, "images.bin"), load_points2d
        )
        pts = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    elif os.path.exists(os.path.join(sparse_dir, "cameras.txt")):
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(
            os.path.join(sparse_dir, "images.txt"), load_points2d
        )
        pts = read_points3d_txt(os.path.join(sparse_dir, "points3D.txt"))
    else:
        raise FileNotFoundError(f"no COLMAP model found in {sparse_dir}")
    return cams, imgs, pts
