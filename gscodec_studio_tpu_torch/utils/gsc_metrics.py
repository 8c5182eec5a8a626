"""MPEG GSC quality metrics: RGB and YCbCr PSNR, luma SSIM and MS-SSIM
(port of gscodec_studio_tpu/utils/gsc_metrics.py): BT.709 RGB->YCbCr,
per-component PSNR in numpy, and the SSIMs of training/losses.py."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.training.losses import ms_ssim, ssim


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0,1] -> YCbCr (BT.709, full range)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    cb = (b - y) / 1.8556 + 0.5
    cr = (r - y) / 1.5748 + 0.5
    return np.stack([y, cb, cr], axis=-1)


def psnr_np(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(max_val**2 / max(mse, 1e-12))


def gsc_metrics(ref: np.ndarray, dist: np.ndarray,
                device: DeviceLike = None) -> Dict[str, float]:
    """QMIV's report for one pair of [H, W, 3] images in [0, 1]: RGB PSNR,
    per-component YCbCr PSNR, and the luma SSIM and MS-SSIM, which run on
    ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    ref, dist = np.asarray(ref), np.asarray(dist)
    out = {"psnr_rgb": psnr_np(ref, dist)}
    ry, dy = rgb_to_ycbcr(ref), rgb_to_ycbcr(dist)
    for i, comp in enumerate(("y", "cb", "cr")):
        out[f"psnr_{comp}"] = psnr_np(ry[..., i], dy[..., i])
    a = torch.as_tensor(np.ascontiguousarray(ry[None, ..., :1]),
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(np.ascontiguousarray(dy[None, ..., :1]),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        out["ssim_y"] = float(ssim(a, b))
        out["msssim_y"] = float(ms_ssim(a, b))
    return out
