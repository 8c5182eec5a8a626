"""Training losses: L1 + SSIM, and PSNR and multi-scale SSIM (port of
gscodec_studio_tpu/training/losses.py).

SSIM uses the separable 11x11 Gaussian window with SAME zero padding, in
float32 throughout: the blur runs with cuDNN off (PyTorch's own depthwise
convolution, which has no TF32 mode), and its backward is the same blur of
the gradient, since the window is symmetric.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur_nchw(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    k = win.shape[0]
    kh = win.reshape(1, 1, k, 1).expand(C, 1, k, 1)
    kw = win.reshape(1, 1, 1, k).expand(C, 1, 1, k)
    with torch.backends.cudnn.flags(enabled=False):
        x = F.conv2d(x, kh, padding=(k // 2, 0), groups=C)
        return F.conv2d(x, kw, padding=(0, k // 2), groups=C)


class _Blur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, win):
        ctx.save_for_backward(win)
        return _blur_nchw(x, win)

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        return _blur_nchw(g.contiguous(), win), None


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W, C] (SAME padding)."""
    x = img.permute(0, 3, 1, 2).contiguous()
    return _Blur.apply(x, win).permute(0, 2, 3, 1)


def _ssim_cs(img0, img1, max_val, win_size, sigma):
    win = torch.as_tensor(_gaussian_window(win_size, sigma),
                          device=img0.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu0 = _filter2d(img0, win)
    mu1 = _filter2d(img1, win)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2d(img0 * img0, win) - mu00
    s11 = _filter2d(img1 * img1, win) - mu11
    s01 = _filter2d(img0 * img1, win) - mu01
    cs = (2 * s01 + c2) / (s00 + s11 + c2)
    lum = (2 * mu01 + c1) / (mu00 + mu11 + c1)
    return lum * cs, cs


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the batch of [B, H, W, C] images in [0, 1]."""
    sm, _ = _ssim_cs(img0, img1, max_val, win_size, sigma)
    return sm.mean()


# Wang et al. 2003 per-scale weights
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
            win_size: int = 11, sigma: float = 1.5,
            weights=_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM of [B, H, W, C] images in [0, 1], with as many of
    the scales as the image size holds (the smaller side at the coarsest
    scale at least ``win_size``). Between scales a 2x2 mean halves the
    images, dropping an odd last row and column."""
    n = len(weights)
    h, w = img0.shape[1:3]
    while n > 1 and min(h, w) // (2 ** (n - 1)) < win_size:
        n -= 1
    ws = torch.tensor(weights[:n], dtype=torch.float32,
                      device=img0.device) / sum(weights[:n])

    def pool(x):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size=2,
                            stride=2).permute(0, 2, 3, 1)

    vals = []
    a, b = img0, img1
    for i in range(n):
        sm, cs = _ssim_cs(a, b, max_val, win_size, sigma)
        vals.append((sm if i == n - 1 else cs).mean())
        if i + 1 < n:
            a, b = pool(a), pool(b)
    v = torch.stack(vals)
    return torch.prod(torch.sign(v) * torch.abs(v) ** ws)


def l1(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return (img0 - img1).abs().mean()


def psnr(img0: torch.Tensor, img1: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = ((img0 - img1) ** 2).mean()
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def combined_loss(render, target, ssim_lambda: float = 0.2):
    """(1 - l) * L1 + l * (1 - SSIM), the 3DGS loss."""
    return (1.0 - ssim_lambda) * l1(render, target) + ssim_lambda * (
        1.0 - ssim(render, target))
