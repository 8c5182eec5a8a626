"""MCMC Gaussian relocation, Eq. 9 of "3DGS as Markov Chain Monte Carlo"
(port of gscodec_studio_tpu/ops/relocation.py).

The reference's per-thread double loop over binomial terms is precomputed
into a cumulative table, so the op is one gather and one small contraction.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=8)
def _cum_binom_table(n_max: int) -> np.ndarray:
    """cum[n, k] = sum_{i=1..n} binom(i-1, k) * (-1)^k / sqrt(k+1), built in
    float64 and stored as float32, so that denom(n, op) = sum_k cum[n, k] *
    op^(k+1) reproduces the reference's double loop."""
    binoms = np.zeros((n_max, n_max), dtype=np.float64)
    for i in range(n_max):
        for k in range(i + 1):
            binoms[i, k] = math.comb(i, k)
    inner = binoms * ((-1.0) ** np.arange(n_max))[None, :] / np.sqrt(
        np.arange(1, n_max + 1))[None, :]
    cum = np.zeros((n_max + 1, n_max), dtype=np.float64)
    cum[1:] = np.cumsum(inner, axis=0)
    return cum.astype(np.float32)


def compute_relocation(
    opacities: torch.Tensor,  # [N] in (0, 1)
    scales: torch.Tensor,  # [N, 3] linear
    ratios: torch.Tensor,  # [N] integer in [1, n_max]
    n_max: int = 51,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a Gaussian into ``ratios`` copies that render the same density:
    new opacity 1 - (1 - o)^(1/n), scales shrunk by the Eq. 9 factor.
    Returns (new_opacities [N], new_scales [N, 3])."""
    dev = opacities.device
    cum = torch.as_tensor(_cum_binom_table(n_max), device=dev)
    ratios = torch.clamp(ratios.to(torch.int64), 1, n_max)
    new_op = 1.0 - torch.pow(1.0 - opacities,
                             1.0 / ratios.to(opacities.dtype))
    k = torch.arange(1, n_max + 1, device=dev).to(opacities.dtype)
    powers = torch.pow(new_op[:, None], k[None, :])  # op^(k+1), k < n_max
    denom = (cum[ratios] * powers).sum(-1)
    coeff = opacities / torch.where(denom == 0, torch.ones_like(denom),
                                    denom)
    return new_op, coeff[:, None] * scales
