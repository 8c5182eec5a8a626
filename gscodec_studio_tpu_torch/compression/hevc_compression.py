"""Single-frame HEVC-grid codec and the hybrid codec (port of
gscodec_studio_tpu/compression/hevc_compression.py): the PNG pipeline with
its 8-bit attribute grids coded as one-frame x265 videos (qp sets the
rate) where an ``ffmpeg`` binary is on the PATH, else as PNGs through the
sequence codec's ``pngseq`` backend; the means stay a 16-bit PNG pair and
shN the k-means codec. ``HybridCompression`` is the rANS codec
(entropy_coding.py) over ``ans_attrs``, PNG grids for the rest.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np

from gscodec_studio_tpu_torch.compression import codecs
from gscodec_studio_tpu_torch.compression.entropy_coding import (
    EntropyCodingCompression)
from gscodec_studio_tpu_torch.compression.outlier_filter import filter_splats
from gscodec_studio_tpu_torch.compression.seq_codec import (_read_video,
                                                            _write_video,
                                                            have_ffmpeg)
from gscodec_studio_tpu_torch.compression.sort import sort_splats
from gscodec_studio_tpu_torch.device import DeviceLike


@dataclasses.dataclass
class HevcCompression:
    """compress(dir, splats) / decompress(dir) -> splats; the shN k-means
    on ``device`` (None means the CUDA card)."""

    qp: int = 20
    backend: str = "auto"  # hevc | pngseq | auto
    shn_clusters: int = 32768
    kmeans_iters: int = 10
    device: DeviceLike = None

    def _backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "hevc" if have_ffmpeg() else "pngseq"

    def compress(self, compress_dir: str, splats: Dict) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        backend = self._backend()
        splats = {k: np.asarray(v) for k, v in splats.items()}
        splats, _ = filter_splats(splats)
        q = splats["quats"]
        q = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12,
                        None)
        splats["quats"] = np.where(q[:, :1] >= 0, q, -q)
        splats, side = sort_splats(splats)
        meta = {"side": side, "backend": backend, "attrs": {}}
        for name, v in splats.items():
            if name == "means":
                meta["attrs"][name] = codecs.compress_png_16bit(
                    compress_dir, name, v.reshape(side, side, -1),
                    log_space=True)
            elif name == "shN":
                meta["attrs"][name] = codecs.compress_kmeans(
                    compress_dir, name, v.reshape(side, side, *v.shape[1:]),
                    self.shn_clusters, iters=self.kmeans_iters,
                    device=self.device)
            else:
                grid = v.reshape(side, side, -1)
                D = grid.shape[-1]
                mins = grid.reshape(-1, D).min(0)
                maxs = grid.reshape(-1, D).max(0)
                scale = np.where(maxs > mins, maxs - mins, 1)
                q8 = np.round((grid - mins) / scale * 255).astype(np.uint8)
                files = [_write_video(
                    os.path.join(compress_dir, f"{name}_{d}"),
                    q8[None, ..., d], backend, self.qp) for d in range(D)]
                meta["attrs"][name] = {
                    "kind": "hevc", "files": files,
                    "shape": list(grid.shape), "mins": mins.tolist(),
                    "maxs": maxs.tolist()}
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        side, backend = meta["side"], meta["backend"]
        n = side * side
        out = {}
        for name, m in meta["attrs"].items():
            if m["kind"] == "png16":
                arr = codecs.decompress_png_16bit(compress_dir, name, m)
            elif m["kind"] == "kmeans":
                arr = codecs.decompress_kmeans(compress_dir, name, m)
            else:
                mins = np.asarray(m["mins"], np.float32)
                maxs = np.asarray(m["maxs"], np.float32)
                scale = np.where(maxs > mins, maxs - mins, 1)
                chans = [_read_video(compress_dir, m["files"][d], backend,
                                     (1, side, side))[0].astype(np.float32)
                         / 255.0 for d in range(m["shape"][-1])]
                arr = np.stack(chans, -1) * scale + mins
            arr = np.asarray(arr, np.float32)
            if name == "opacities":
                out[name] = arr.reshape(n)
            elif name == "sh0":
                out[name] = arr.reshape(n, 1, 3)
            elif name == "shN":
                out[name] = arr.reshape(n, -1, 3)
            else:
                out[name] = arr.reshape(n, -1)
        return out


@dataclasses.dataclass
class HybridCompression:
    """rANS for the low-entropy quantized attributes ``ans_attrs``, PNG
    grids for the rest."""

    ans_attrs: tuple = ("scales", "quats")
    shn_clusters: int = 32768
    kmeans_iters: int = 10
    device: DeviceLike = None

    def compress(self, compress_dir: str, splats: Dict,
                 entropy_models=None) -> None:
        EntropyCodingCompression(
            ans_attrs=self.ans_attrs, shn_clusters=self.shn_clusters,
            kmeans_iters=self.kmeans_iters, device=self.device,
        ).compress(compress_dir, splats, entropy_models)

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        return EntropyCodingCompression(device=self.device).decompress(
            compress_dir)
