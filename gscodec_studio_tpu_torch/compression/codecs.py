"""Per-attribute codecs of the PNG pipeline (port of
gscodec_studio_tpu/compression/codecs.py).

Every codec is a pair ``compress(dir, name, grid, ...) -> meta`` /
``decompress(dir, name, meta) -> grid`` over [side, side, C] float arrays
(the PLAS-sorted grid layout). The files and the meta are the JAX
package's, so either package decodes the other's bitstream: PNGs through
the port's own reader and writer (png_io.py), the means' sign-log
transform with the JAX package's float32 bits (f32_math.py), and the shN
k-means on ``device``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from gscodec_studio_tpu_torch.compression import f32_math
from gscodec_studio_tpu_torch.compression.kmeans import kmeans
from gscodec_studio_tpu_torch.compression.png_io import read_png, write_png
from gscodec_studio_tpu_torch.device import DeviceLike


def _split_channels(arr: np.ndarray):
    """Split [H, W, C] into PNG-codable chunks of <= 4 channels
    (1/3/4 channels map to L/RGB/RGBA)."""
    C = arr.shape[-1]
    chunks, i = [], 0
    while i < C:
        take = 4 if C - i == 4 else min(3, C - i) if C - i != 2 else 1
        chunks.append(arr[..., i:i + take])
        i += take
    return chunks


def _write_chunks(compress_dir, stem: str, img: np.ndarray) -> list:
    files = []
    for i, chunk in enumerate(_split_channels(img)):
        fn = f"{stem}{i}.png"
        write_png(os.path.join(compress_dir, fn),
                  chunk[..., 0] if chunk.shape[-1] == 1 else chunk)
        files.append(fn)
    return files


def _read_chunks(compress_dir, files) -> np.ndarray:
    parts = []
    for fn in files:
        a = read_png(os.path.join(compress_dir, fn))
        parts.append(a[..., None] if a.ndim == 2 else a)
    return np.concatenate(parts, axis=-1)


def _range(grid: np.ndarray):
    flat = grid.reshape(-1, grid.shape[-1])
    mins, maxs = flat.min(0), flat.max(0)
    return mins, maxs, np.where(maxs > mins, maxs - mins, 1.0)


def compress_png(compress_dir, name, grid, n_bits=8) -> Dict:
    """k-bit min/max-normalized PNG."""
    grid = np.asarray(grid, np.float32)
    mins, maxs, scale = _range(grid)
    norm = (grid - mins) / scale
    q = np.round(norm * (2 ** n_bits - 1)).astype(
        np.uint8 if n_bits <= 8 else np.uint16)
    return {
        "kind": "png", "files": _write_chunks(compress_dir, f"{name}_", q),
        "shape": list(grid.shape), "mins": mins.tolist(),
        "maxs": maxs.tolist(), "n_bits": n_bits,
    }


def decompress_png(compress_dir, name, meta) -> np.ndarray:
    q = _read_chunks(compress_dir, meta["files"]).astype(np.float32)
    norm = q / (2 ** meta["n_bits"] - 1)
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    scale = np.where(maxs > mins, maxs - mins, 1.0)
    return (norm * scale + mins).reshape(meta["shape"])


def compress_png_16bit(compress_dir, name, grid, log_space=True) -> Dict:
    """16 bits split into upper and lower 8-bit PNGs, optionally in
    sign-log space: the means codec."""
    grid = np.asarray(grid, np.float32)
    if log_space:
        grid = f32_math.log_transform(grid)
    mins, maxs, scale = _range(grid)
    q = np.round((grid - mins) / scale * 65535.0).astype(np.uint16)
    upper = (q >> 8).astype(np.uint8)
    lower = (q & 0xFF).astype(np.uint8)
    files = (_write_chunks(compress_dir, f"{name}_u", upper)
             + _write_chunks(compress_dir, f"{name}_l", lower))
    return {
        "kind": "png16", "files": files, "shape": list(grid.shape),
        "mins": mins.tolist(), "maxs": maxs.tolist(), "log_space": log_space,
    }


def decompress_png_16bit(compress_dir, name, meta) -> np.ndarray:
    n = len(meta["files"]) // 2
    upper = _read_chunks(compress_dir, meta["files"][:n]).astype(np.uint16)
    lower = _read_chunks(compress_dir, meta["files"][n:]).astype(np.uint16)
    q = ((upper << 8) | lower).astype(np.float32) / 65535.0
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    scale = np.where(maxs > mins, maxs - mins, 1.0)
    out = (q * scale + mins).reshape(meta["shape"])
    if meta.get("log_space"):
        out = f32_math.inverse_log_transform(out)
    return out.astype(np.float32)


def compress_kmeans(compress_dir, name, grid, n_clusters=32768, q_bits=8,
                    iters=10, device: DeviceLike = None) -> Dict:
    """Masked k-means VQ, the shN codec: the all-zero rows are bit-packed
    out, the rest indexed into 8-bit-quantized centroids. The k-means runs
    on ``device`` (None means the CUDA card)."""
    grid = np.asarray(grid, np.float32)
    side = grid.shape[0]
    flat = grid.reshape(side * side, -1)
    mask = np.any(flat != 0, axis=1)
    used = flat[mask]
    meta = {
        "kind": "kmeans", "shape": list(grid.shape),
        "n_points": int(mask.sum()),
    }
    np.save(os.path.join(compress_dir, f"{name}_mask.npy"), np.packbits(mask))
    if used.shape[0] == 0:
        meta["empty"] = True
        return meta
    k = int(min(n_clusters, used.shape[0]))
    centroids, labels = kmeans(used, k, iters=iters, device=device)
    mins, maxs = centroids.min(), centroids.max()
    scale = (maxs - mins) or 1.0
    cq = np.round((centroids - mins) / scale * (2 ** q_bits - 1)).astype(
        np.uint8)
    np.savez_compressed(
        os.path.join(compress_dir, f"{name}_vq.npz"), centroids=cq,
        labels=labels.astype(np.uint16 if k <= 65536 else np.uint32))
    meta.update(mins=float(mins), maxs=float(maxs), q_bits=q_bits, k=k)
    return meta


def decompress_kmeans(compress_dir, name, meta) -> np.ndarray:
    shape = meta["shape"]
    flat = np.zeros((shape[0] * shape[1], int(np.prod(shape[2:]))),
                    np.float32)
    mask = np.unpackbits(
        np.load(os.path.join(compress_dir, f"{name}_mask.npy")),
        count=shape[0] * shape[1]).astype(bool)
    if not meta.get("empty"):
        with np.load(os.path.join(compress_dir, f"{name}_vq.npz")) as z:
            scale = meta["maxs"] - meta["mins"] or 1.0
            centroids = (z["centroids"].astype(np.float32)
                         / (2 ** meta["q_bits"] - 1) * scale + meta["mins"])
            flat[mask] = centroids[z["labels"].astype(np.int64)]
    return flat.reshape(shape)


def compress_npz(compress_dir, name, grid) -> Dict:
    """Lossless fallback for any other attribute."""
    np.savez_compressed(os.path.join(compress_dir, f"{name}.npz"),
                        arr=np.asarray(grid))
    return {"kind": "npz", "shape": list(np.asarray(grid).shape)}


def decompress_npz(compress_dir, name, meta) -> np.ndarray:
    with np.load(os.path.join(compress_dir, f"{name}.npz")) as z:
        return z["arr"]
