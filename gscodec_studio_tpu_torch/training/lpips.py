"""The LPIPS perceptual metric (port of gscodec_studio_tpu/training/lpips.py;
reference: torchmetrics' LPIPS with AlexNet features): AlexNet's five conv
layers tapped after each ReLU, each tap unit-normalised over its channels,
the squared difference weighted by the learned linear heads (clamped at
0), averaged over space and summed over the taps.

No pretrained weights ship with the repository, so the metric is gated on
a weights file: ``GSC_LPIPS_WEIGHTS`` (default ~/.cache/gsc/lpips_alex.npz)
in the JAX package's npz layout: conv{i}_w [kh, kw, cin, cout], conv{i}_b
[cout] for the five convs and lin{i}_w [ci] for the five heads.
``convert_torch_lpips`` writes that file from the ``lpips`` package, on a
machine that has it and its pretrained nets.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

# AlexNet's feature convs: (out channels, kernel, stride, padding); taps
# after each ReLU, 3x3/2 max-pools after taps 0 and 1
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
# LPIPS's input scaling, in [-1, 1] space
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS_PATH = os.path.expanduser("~/.cache/gsc/lpips_alex.npz")


def _weights_path(path=None) -> str:
    # read when called, so that the variable can be set after import
    return path or os.environ.get("GSC_LPIPS_WEIGHTS", DEFAULT_WEIGHTS_PATH)


def lpips_available(path=None) -> bool:
    return os.path.exists(_weights_path(path))


def load_lpips_weights(path=None, device: DeviceLike = None
                       ) -> Dict[str, torch.Tensor]:
    """The npz's arrays as float32 tensors on ``device`` (None: the card);
    the convs' kernels stay in the npz layout [kh, kw, cin, cout]."""
    path = _weights_path(path)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}. No pretrained nets ship "
            "with the repository; convert them once elsewhere with "
            "gscodec_studio_tpu_torch.training.lpips.convert_torch_lpips and "
            "point GSC_LPIPS_WEIGHTS at the npz.")
    dev = resolve_device(device)
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=dev)
                for k in z.files}


def _features(weights: Dict[str, torch.Tensor],
              x: torch.Tensor) -> List[torch.Tensor]:
    """x [B, H, W, 3] in [0, 1] -> the five taps [B, c, h, w]."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    h = ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    for i, (_, _, stride, pad) in enumerate(_ALEX):
        w = torch.as_tensor(weights[f"conv{i}_w"]).permute(3, 2, 0, 1)
        h = F.relu(F.conv2d(h, w.to(h), torch.as_tensor(
            weights[f"conv{i}_b"]).to(h), stride=stride, padding=pad))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return taps


def lpips(img0: torch.Tensor, img1: torch.Tensor,
          weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The LPIPS distance of [B, H, W, 3] images in [0, 1], averaged over
    the batch (a scalar tensor)."""
    total = img0.new_zeros(())
    for i, (a, b) in enumerate(zip(_features(weights, img0),
                                   _features(weights, img1))):
        na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
        lin = torch.clamp(torch.as_tensor(weights[f"lin{i}_w"]).to(a),
                          min=0.0)
        total = total + (((na - nb) ** 2) * lin[None, :, None, None]).sum(
            1).mean()
    return total


def convert_torch_lpips(out_path: str) -> None:
    """Writes the ``lpips`` package's AlexNet convs and linear heads in the
    npz layout above (needs ``lpips`` and torchvision with their pretrained
    weights)."""
    import lpips as lpips_pkg  # type: ignore

    net = lpips_pkg.LPIPS(net="alex")
    out = {}
    i = 0
    for sl in (net.net.slice1, net.net.slice2, net.net.slice3,
               net.net.slice4, net.net.slice5):
        for m in sl:
            if m.__class__.__name__ == "Conv2d":
                w = m.weight.detach().cpu().numpy()  # [cout, cin, kh, kw]
                out[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))
                out[f"conv{i}_b"] = m.bias.detach().cpu().numpy()
                i += 1
    for j, lin in enumerate(net.lins):
        out[f"lin{j}_w"] = lin.model[-1].weight.detach().cpu().numpy() \
            .reshape(-1)
    np.savez(out_path, **out)
