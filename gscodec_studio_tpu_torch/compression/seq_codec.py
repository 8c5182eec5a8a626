"""Sequence codec for tracked splat sequences (port of
gscodec_studio_tpu/compression/seq_codec.py): the per-frame splat dicts
(one correspondence across frames) become per-attribute videos
[T, side, side, D], sorted by one PLAS permutation of frame 0 (or each
frame's own with ``all_intra``); the means in log space at 16 bits as an
upper and a lower 8-bit video; each channel a video.

The video backend: ``hevc`` encodes with x265 through an ``ffmpeg``
binary and decodes through ffmpeg's raw output (no imageio on the card
machine); ``pngseq`` writes each frame as a PNG (the port's png_io), and,
as PNG is lossless, maps qp onto the attributes' bit depth (qp 30/25/20/15
-> 4/5/6/8 bits) so that the rate points differ. ``auto`` takes hevc where
ffmpeg is on the PATH. The files and meta.json are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
from typing import Dict, List

import numpy as np

from gscodec_studio_tpu_torch.compression import f32_math, native
from gscodec_studio_tpu_torch.compression.png_io import read_png, write_png


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _need_ffmpeg() -> None:
    if not have_ffmpeg():
        raise RuntimeError("backend='hevc' needs an ffmpeg binary on the "
                           "PATH, and there is none: use backend='pngseq' "
                           "(or 'auto', which falls back to it)")


def _write_video(path_base: str, frames_u8: np.ndarray, backend: str,
                 qp: int) -> List[str]:
    """frames_u8 [T, H, W] or [T, H, W, 3] uint8 -> the files written
    (names relative to the directory of ``path_base``)."""
    if backend == "hevc":
        _need_ffmpeg()
        tmp = path_base + "_frames"
        os.makedirs(tmp, exist_ok=True)
        for i, fr in enumerate(frames_u8):
            write_png(os.path.join(tmp, f"{i:05d}.png"), fr)
        out = path_base + ".mp4"
        fmt = "gray" if frames_u8.ndim == 3 else "yuv444p"
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i",
             os.path.join(tmp, "%05d.png"), "-c:v", "libx265",
             "-x265-params", f"qp={qp}:lossless=0", "-pix_fmt", fmt, out],
            check=True)
        shutil.rmtree(tmp)
        return [os.path.basename(out)]
    if backend == "pngseq":
        files = []
        for i, fr in enumerate(frames_u8):
            fn = f"{os.path.basename(path_base)}_{i:05d}.png"
            write_png(os.path.join(os.path.dirname(path_base), fn), fr)
            files.append(fn)
        return files
    raise ValueError(backend)


def _read_video(dirname: str, files: List[str], backend: str,
                shape) -> np.ndarray:
    """The frames of ``files``: [T, H, W] for a ``shape`` (T, H, W), else
    [T, H, W, 3]. An mp4 is decoded by ffmpeg to raw gray or RGB bytes."""
    if backend == "hevc":
        _need_ffmpeg()
        gray = len(shape) == 3
        raw = subprocess.run(
            ["ffmpeg", "-loglevel", "error", "-i",
             os.path.join(dirname, files[0]), "-f", "rawvideo", "-pix_fmt",
             "gray" if gray else "rgb24", "-"],
            check=True, capture_output=True).stdout
        h, w = shape[1], shape[2]
        frames = np.frombuffer(raw, np.uint8).reshape(
            (-1, h, w) if gray else (-1, h, w, 3))
        return frames[: shape[0]]
    return np.stack([read_png(os.path.join(dirname, f)) for f in files])


@dataclasses.dataclass
class SeqCodec:
    """compress(dir, frames) / decompress(dir) -> frames."""

    backend: str = "auto"  # hevc | pngseq | auto
    qp: int = 20
    all_intra: bool = False  # each frame its own sort (else frame 0's)
    sweeps_per_level: int = 2

    def _backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "hevc" if have_ffmpeg() else "pngseq"

    def pngseq_bits(self) -> int:
        """The attributes' bit depth under pngseq at this qp."""
        return int(np.clip(round((42 - self.qp) / 3.4), 4, 8))

    def compress(self, compress_dir: str, frames: List[Dict]) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        backend = self._backend()
        T = len(frames)
        n = min(len(f["means"]) for f in frames)
        side = int(np.floor(np.sqrt(n)))
        keep_n = side * side

        def sort_perm(splats):
            feats = []
            for k in ("means", "scales", "opacities"):
                v = np.asarray(splats[k], np.float32).reshape(
                    len(splats[k]), -1)[:keep_n]
                std = v.std(0)
                std[std == 0] = 1
                feats.append((v - v.mean(0)) / std)
            return native.plas_sort(np.concatenate(feats, 1), side,
                                    sweeps_per_level=self.sweeps_per_level)

        perms = ([sort_perm(f) for f in frames] if self.all_intra
                 else [sort_perm(frames[0])] * T)
        meta = {"side": side, "T": T, "backend": backend,
                "all_intra": self.all_intra, "attrs": {}}
        for name in sorted(frames[0].keys()):
            if np.asarray(frames[0][name]).size == 0:
                # a zero-width attribute (shN with no bands): its trailing
                # shape, so that decode restores the empty array
                meta["attrs"][name] = {"empty_shape": list(
                    np.asarray(frames[0][name]).shape[1:])}
                continue
            video = np.stack([
                np.asarray(f[name], np.float32)[:keep_n][perm].reshape(
                    side, side, -1) for f, perm in zip(frames, perms)])
            D = video.shape[-1]
            if name == "means":
                video = f32_math.log_transform(video)
            mins = video.reshape(-1, D).min(0)
            maxs = video.reshape(-1, D).max(0)
            scale = np.where(maxs > mins, maxs - mins, 1)
            norm = (video - mins) / scale
            m = {"shape": list(video.shape), "mins": mins.tolist(),
                 "maxs": maxs.tolist(), "files": [], "bits": 8}
            if name == "means":
                q = np.round(norm * 65535).astype(np.uint16)
                m["bits"] = 16
                for tag, img in (("u", (q >> 8).astype(np.uint8)),
                                 ("l", (q & 0xFF).astype(np.uint8))):
                    for d in range(D):
                        m["files"].append(_write_video(
                            os.path.join(compress_dir, f"{name}_{tag}{d}"),
                            img[..., d], backend, max(self.qp - 10, 0)))
            else:
                bits = self.pngseq_bits() if backend == "pngseq" else 8
                m["bits"] = bits
                q = np.round(norm * (2 ** bits - 1)).astype(np.uint8)
                for d in range(D):
                    m["files"].append(_write_video(
                        os.path.join(compress_dir, f"{name}_{d}"),
                        q[..., d], backend, self.qp))
            meta["attrs"][name] = m
        with open(os.path.join(compress_dir, "meta.json"), "w") as fh:
            json.dump(meta, fh)

    def decompress(self, compress_dir: str) -> List[Dict]:
        with open(os.path.join(compress_dir, "meta.json")) as fh:
            meta = json.load(fh)
        backend = meta["backend"]
        side, T = meta["side"], meta["T"]
        n = side * side
        frames = [dict() for _ in range(T)]
        for name, m in meta["attrs"].items():
            if "empty_shape" in m:
                for t in range(T):
                    frames[t][name] = np.zeros([n] + m["empty_shape"],
                                               np.float32)
                continue
            _, s1, s2, D = m["shape"]
            mins = np.asarray(m["mins"], np.float32)
            maxs = np.asarray(m["maxs"], np.float32)
            scale = np.where(maxs > mins, maxs - mins, 1)
            chans = []
            if m["bits"] == 16:
                half = len(m["files"]) // 2
                for d in range(D):
                    up = _read_video(compress_dir, m["files"][d], backend,
                                     (T, s1, s2)).astype(np.uint16)
                    lo = _read_video(compress_dir, m["files"][half + d],
                                     backend, (T, s1, s2)).astype(np.uint16)
                    chans.append(((up << 8) | lo).astype(np.float32)
                                 / 65535.0)
            else:
                denom = float(2 ** m["bits"] - 1)
                for d in range(D):
                    v = _read_video(compress_dir, m["files"][d], backend,
                                    (T, s1, s2))
                    chans.append(v.astype(np.float32) / denom)
            video = np.stack(chans, -1) * scale + mins
            if name == "means":
                video = f32_math.inverse_log_transform(video)
            for t in range(T):
                frames[t][name] = video[t].reshape(n, D)
        return frames
