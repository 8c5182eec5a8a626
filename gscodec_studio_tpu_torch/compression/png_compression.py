"""The PNG-grid test-time codec (port of
gscodec_studio_tpu/compression/png_compression.py):

  opacity filter -> normalize quats -> crop to a square -> PLAS sort ->
  per-attribute codecs: means 16-bit dual PNG (sign-log space), scales,
  quats, sh0 and opacities 8-bit PNG, shN masked k-means VQ, anything
  else npz -> meta.json.

The bytes on disk are the rate (``compressed_size``). The files are the
JAX package's: each package decodes the other's bitstream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np

from gscodec_studio_tpu_torch.compression import codecs
from gscodec_studio_tpu_torch.compression.outlier_filter import filter_splats
from gscodec_studio_tpu_torch.compression.sort import sort_splats
from gscodec_studio_tpu_torch.device import DeviceLike


@dataclasses.dataclass
class PngCompression:
    """compress(dir, splats) / decompress(dir) -> splats. The shN k-means
    runs on ``device`` (None means the CUDA card). ``seconds`` holds the
    last compress's stages: filter, plas (the crop and the sort), kmeans
    and png_write (every other attribute's codec)."""

    use_sort: bool = True
    verbose: bool = False
    shn_clusters: int = 32768
    kmeans_iters: int = 10
    device: DeviceLike = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def _codec_for(self, name: str):
        if name == "means":
            return (lambda d, n, g: codecs.compress_png_16bit(
                d, n, g, log_space=True), codecs.decompress_png_16bit)
        if name in ("scales", "quats", "opacities", "sh0"):
            return (lambda d, n, g: codecs.compress_png(d, n, g, n_bits=8),
                    codecs.decompress_png)
        if name == "shN":
            return (lambda d, n, g: codecs.compress_kmeans(
                d, n, g, self.shn_clusters, iters=self.kmeans_iters,
                device=self.device), codecs.decompress_kmeans)
        return (codecs.compress_npz, codecs.decompress_npz)

    def compress(self, compress_dir: str, splats: Dict) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        seconds = {"filter": 0.0, "plas": 0.0, "kmeans": 0.0,
                   "png_write": 0.0}
        t0 = time.perf_counter()
        splats = {k: np.asarray(v) for k, v in splats.items()}
        splats, _ = filter_splats(splats)
        # sign-canonical unit quaternions before quantization
        q = splats["quats"]
        q = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12,
                        None)
        splats["quats"] = np.where(q[:, :1] >= 0, q, -q)
        t1 = time.perf_counter()
        seconds["filter"] = t1 - t0
        if self.use_sort:
            splats, side = sort_splats(splats, self.verbose)
        else:
            n = len(splats["means"])
            side = int(np.floor(np.sqrt(n)))
            keep = np.argsort(splats["opacities"])[::-1][: side * side]
            splats = {k: v[np.sort(keep)] for k, v in splats.items()}
        seconds["plas"] = time.perf_counter() - t1

        meta = {"side": side, "attrs": {}}
        for name, v in splats.items():
            t1 = time.perf_counter()
            grid = v.reshape(side, side, *v.shape[1:])
            if grid.ndim == 2:
                grid = grid[..., None]
            if name != "shN" and grid.ndim > 3:  # k-means keeps its dims
                grid = grid.reshape(side, side, -1)
            comp, _ = self._codec_for(name)
            meta["attrs"][name] = comp(compress_dir, name, grid)
            stage = "kmeans" if name == "shN" else "png_write"
            seconds[stage] += time.perf_counter() - t1
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        self.seconds = seconds

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        side = meta["side"]
        out = {}
        n = side * side
        for name, m in meta["attrs"].items():
            _, dec = self._codec_for(name)
            arr = np.asarray(dec(compress_dir, name, m), np.float32)
            arr = arr.reshape(m["shape"])
            if name == "opacities":
                out[name] = arr.reshape(n)
            elif name == "sh0":
                out[name] = arr.reshape(n, 1, 3)
            elif name == "shN":
                out[name] = arr.reshape(n, -1, 3)
            else:
                out[name] = arr.reshape(n, -1)
        return out


def compressed_size(compress_dir: str) -> int:
    """Total bytes on disk under ``compress_dir``."""
    total = 0
    for root, _, files in os.walk(compress_dir):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total
