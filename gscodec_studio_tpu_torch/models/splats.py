"""Static 3DGS splat parameters (port of
gscodec_studio_tpu/models/splats.py, the parts that rendering needs)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

PARAM_NAMES = ("means", "quats", "scales", "opacities", "sh0", "shN")

# Log-scale floor inside the activation (the JAX package's LOG_SCALE_FLOOR):
# exp(-15) is sub-pixel at any working distance, and flooring keeps
# degenerate needles out of the projection.
LOG_SCALE_FLOOR = -15.0


class SplatModel(nn.Module):
    """The six parameter tensors of a splat scene, as the JAX package saves
    them: means [N,3], quats [N,4], scales [N,3] (log), opacities [N]
    (logit), sh0 [N,1,3], shN [N,K-1,3]."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        missing = [k for k in PARAM_NAMES if k not in params]
        if missing:
            raise ValueError(f"splat parameters missing: {missing}")
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(params[name]))

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k_total = 1 + self.shN.shape[1]
        return max(int(round(np.sqrt(k_total))) - 1, 0)

    def sh_coeffs(self) -> torch.Tensor:
        """[N, K, 3]: sh0 followed by shN."""
        return torch.cat([self.sh0, self.shN], dim=1)


def from_jax_splats(d: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> SplatModel:
    """A SplatModel from the JAX package's splat dict (log scales, logit
    opacities), on ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    n = len(d["means"])
    sh0 = np.asarray(d.get("sh0", np.zeros((n, 1, 3)))).reshape(n, 1, 3)
    shN = np.asarray(d.get("shN", np.zeros((n, 0, 3)))).reshape(n, -1, 3)
    arrays = dict(means=d["means"], quats=d["quats"], scales=d["scales"],
                  opacities=np.asarray(d["opacities"]).reshape(n),
                  sh0=sh0, shN=shN)
    return SplatModel({
        k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
        for k, v in arrays.items()
    })


def splat_activations(
    splats,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(means, quats, exp(max(scales, floor)), sigmoid(opacities)) -- the
    linear-domain tensors the renderer consumes. ``splats`` is a SplatModel
    or a dict of tensors."""
    get = (lambda k: splats[k]) if isinstance(splats, dict) else \
        (lambda k: getattr(splats, k))
    return (
        get("means"),
        get("quats"),
        torch.exp(torch.clamp(get("scales"), min=LOG_SCALE_FLOOR)),
        torch.sigmoid(get("opacities")),
    )
