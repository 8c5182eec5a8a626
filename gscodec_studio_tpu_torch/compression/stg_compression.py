"""PNG codec of the SpacetimeGaussian (dynamic) attribute set (port of
gscodec_studio_tpu/compression/stg_compression.py): the means as a 16-bit
log-space PNG pair, the 9-channel motion as three RGB PNGs, scales and
quats as ``quantization``-bit PNGs, the opacities, trbf, omega and the
feature banks as 8-bit PNGs (the direction and time banks through the
k-means codec with ``use_kmeans``), anything else as a lossless npz. The
PLAS sort leaves motion and omega out of its keys. The files and meta.json
are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np

from gscodec_studio_tpu_torch.compression import codecs
from gscodec_studio_tpu_torch.compression.outlier_filter import filter_splats
from gscodec_studio_tpu_torch.compression.sort import sort_splats
from gscodec_studio_tpu_torch.device import DeviceLike

# rotation-like periodic content aliases under the 2-D sort: not a key
_NON_SORT_KEYS = ("motion", "omega")
_PNG8 = ("opacities", "trbf_center", "trbf_scale", "omega", "colors",
         "features_dir", "features_time")


@dataclasses.dataclass
class STGPngCompression:
    """compress(dir, splats) / decompress(dir) -> splats. The k-means runs
    on ``device`` (None means the CUDA card)."""

    use_sort: bool = True
    quantization: int = 8  # scales' and quats' bit depth
    use_kmeans: bool = False
    device: DeviceLike = None

    def _plan(self, name: str):
        """(kind, kwargs) of an attribute's codec."""
        if name == "means":
            return "png16", {"log_space": True}
        if name == "motion":
            return "multi_png", {}
        if name in ("scales", "quats"):
            return "png", {"n_bits": self.quantization}
        if name in ("features_dir", "features_time") and self.use_kmeans:
            return "kmeans", {"n_clusters": 4096, "device": self.device}
        if name in _PNG8:
            return "png", {"n_bits": 8}
        return "npz", {}

    def compress(self, compress_dir: str, splats: Dict) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        splats = {k: np.asarray(v) for k, v in splats.items()}
        splats, _ = filter_splats(splats)
        q = splats["quats"]
        q = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12,
                        None)
        splats["quats"] = np.where(q[:, :1] >= 0, q, -q)
        if self.use_sort:
            splats, side = sort_splats(splats, sort_keys=[
                k for k in splats if k not in _NON_SORT_KEYS])
        else:
            side = int(np.floor(np.sqrt(len(splats["means"]))))
            splats = {k: v[: side * side] for k, v in splats.items()}

        meta = {"side": side, "attrs": {}}
        for name, v in splats.items():
            grid = v.reshape(side, side, -1)
            kind, kw = self._plan(name)
            if kind == "png16":
                m = codecs.compress_png_16bit(compress_dir, name, grid, **kw)
            elif kind == "multi_png":
                m = {"kind": "multi_png", "shape": list(grid.shape),
                     "parts": [codecs.compress_png(
                         compress_dir, f"{name}_p{i}",
                         grid[..., 3 * i: 3 * i + 3], n_bits=8)
                         for i in range(3)]}
            elif kind == "kmeans":
                m = codecs.compress_kmeans(compress_dir, name, grid, **kw)
            elif kind == "npz":
                m = codecs.compress_npz(compress_dir, name, grid)
            else:
                m = codecs.compress_png(compress_dir, name, grid, **kw)
            meta["attrs"][name] = m
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        n = meta["side"] ** 2
        out = {}
        for name, m in meta["attrs"].items():
            if m["kind"] == "png16":
                arr = codecs.decompress_png_16bit(compress_dir, name, m)
            elif m["kind"] == "multi_png":
                arr = np.concatenate([
                    codecs.decompress_png(compress_dir, f"{name}_p{i}", pm)
                    for i, pm in enumerate(m["parts"])], axis=-1)
            elif m["kind"] == "kmeans":
                arr = codecs.decompress_kmeans(compress_dir, name, m)
            elif m["kind"] == "npz":
                arr = codecs.decompress_npz(compress_dir, name, m)
            else:
                arr = codecs.decompress_png(compress_dir, name, m)
            D = int(np.prod(np.asarray(arr.shape[2:])))
            out[name] = np.asarray(arr, np.float32).reshape(n, D).squeeze()
            if out[name].ndim == 1 and D > 1:
                out[name] = out[name].reshape(n, D)
        return out
