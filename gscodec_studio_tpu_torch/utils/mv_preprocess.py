"""MPEG GSC multiview-video preprocessing (port of
gscodec_studio_tpu/utils/mv_preprocess.py): per-view YUV 4:2:0 videos ->
per-frame PNG folders (the port's png_io) -> one COLMAP reconstruction a
frame that reuses the calibrated frame-0 poses and only triangulates. The
``colmap`` binary is external: ``run_per_frame_colmap`` lists its plan with
``dry_run`` and raises where the binary is missing.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np

from gscodec_studio_tpu_torch.compression.png_io import write_png

# BT.709 limited-range YCbCr -> RGB
_YUV2RGB = np.array([[1.16438, 0.0, 1.79274],
                     [1.16438, -0.21325, -0.53291],
                     [1.16438, 2.11240, 0.0]], np.float32)


def yuv420_to_rgb_frames(path: str, width: int, height: int,
                         max_frames: Optional[int] = None
                         ) -> List[np.ndarray]:
    """Float RGB frames in [0, 1] of a raw planar 8-bit YUV 4:2:0 file."""
    ysz = width * height
    csz = ysz // 4
    frame_bytes = ysz + 2 * csz
    frames = []
    with open(path, "rb") as f:
        while max_frames is None or len(frames) < max_frames:
            buf = f.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            raw = np.frombuffer(buf, np.uint8)
            y = raw[:ysz].reshape(height, width).astype(np.float32)
            u = raw[ysz:ysz + csz].reshape(height // 2, width // 2)
            v = raw[ysz + csz:].reshape(height // 2, width // 2)
            u = u.repeat(2, 0).repeat(2, 1).astype(np.float32)
            v = v.repeat(2, 0).repeat(2, 1).astype(np.float32)
            ycc = np.stack([(y - 16.0), (u - 128.0), (v - 128.0)],
                           axis=-1) / 255.0
            frames.append(np.clip(ycc @ _YUV2RGB.T, 0.0, 1.0))
    return frames


def yuv_to_png_dirs(yuv_paths: Sequence[str], width: int, height: int,
                    out_root: str,
                    view_names: Optional[Sequence[str]] = None) -> List[str]:
    """Per-view YUV videos -> per-frame folders frame_XXXX/images/<view>.png;
    returns the frame folders."""
    names = view_names or [os.path.splitext(os.path.basename(p))[0]
                           for p in yuv_paths]
    all_frames = [yuv420_to_rgb_frames(p, width, height) for p in yuv_paths]
    T = min(len(f) for f in all_frames)
    dirs = []
    for t in range(T):
        d = os.path.join(out_root, f"frame_{t:04d}", "images")
        os.makedirs(d, exist_ok=True)
        for name, frames in zip(names, all_frames):
            write_png(os.path.join(d, f"{name}.png"),
                      (frames[t] * 255).astype(np.uint8))
        dirs.append(os.path.dirname(d))
    return dirs


def have_colmap() -> bool:
    return shutil.which("colmap") is not None


def per_frame_colmap_commands(frame_dir: str,
                              shared_sparse_dir: str) -> List[List[str]]:
    """The COLMAP commands for one frame folder: features, matching, and
    triangulation with the shared (frame-0) poses held fixed."""
    db = os.path.join(frame_dir, "database.db")
    images = os.path.join(frame_dir, "images")
    out = os.path.join(frame_dir, "sparse")
    return [
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", images],
        ["colmap", "exhaustive_matcher", "--database_path", db],
        ["colmap", "point_triangulator", "--database_path", db,
         "--image_path", images, "--input_path", shared_sparse_dir,
         "--output_path", out],
    ]


def run_per_frame_colmap(frame_dirs: Sequence[str], shared_sparse_dir: str,
                         dry_run: bool = False) -> Dict[str, List[List[str]]]:
    """Runs (or with ``dry_run`` lists) each frame's COLMAP commands;
    raises where the colmap binary is not on the PATH."""
    plans = {d: per_frame_colmap_commands(d, shared_sparse_dir)
             for d in frame_dirs}
    if dry_run:
        return plans
    if not have_colmap():
        raise RuntimeError("colmap binary not found on PATH: install COLMAP "
                           "or use dry_run=True to inspect the per-frame "
                           "command plan.")
    for d, cmds in plans.items():
        os.makedirs(os.path.join(d, "sparse"), exist_ok=True)
        for cmd in cmds:
            subprocess.run(cmd, check=True)
    return plans
