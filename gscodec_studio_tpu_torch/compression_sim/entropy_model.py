"""The fully factorized entropy model for rate estimation (port of the
factorized half of gscodec_studio_tpu/compression_sim/entropy_model.py;
Balle et al., "Variational image compression with a scale hyperprior",
appendix 6.1).

Each channel has a monotone chain of softplus matrices, biases and
tanh-gated factors, its logit CDF c(x); the likelihood of a quantized value
is sigmoid(c(x + Q/2)) - sigmoid(c(x - Q/2)) and its bits are -log2 of it.
A model's parameters are {"matrices": [...], "biases": [...], "factors":
[...]}, each entry a [C, f_out, f_in] or [C, f_out, 1] tensor. The
hash-grid conditioned Gaussian model (``gaussian_bits``) waits for a later
slice (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

LIKELIHOOD_BOUND = 1e-6


def init_factorized(channel: int, filters: Sequence[int] = (3, 3, 3),
                    init_scale: float = 10.0,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> Dict:
    """Parameters of the factorized CDF chain: constant matrices, biases
    uniform in [-0.5, 0.5) from ``generator``, zero factors."""
    dims = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    matrices, biases, factors = [], [], []
    for i in range(len(filters) + 1):
        init = math.log(math.expm1(1.0 / scale / dims[i + 1]))
        matrices.append(torch.full((channel, dims[i + 1], dims[i]), init,
                                   dtype=torch.float32, device=device))
        biases.append(torch.rand((channel, dims[i + 1], 1),
                                 generator=generator, device=device) - 0.5)
        if i < len(filters):
            factors.append(torch.zeros((channel, dims[i + 1], 1),
                                       dtype=torch.float32, device=device))
    return {"matrices": matrices, "biases": biases, "factors": factors}


def _logits_cumulative(params: Dict, logits: torch.Tensor) -> torch.Tensor:
    """logits [C, 1, N] -> [C, 1, N] through the monotone chain. Each layer's
    [C, f_out, f_in] by [C, f_in, N] product (f_in <= 3) is a broadcast
    multiply and a sum over f_in: as a batched matrix product its weight
    gradient is a reduction over all N values, which cuBLAS ran in ~1 ms a
    call at N = 120,000 on the H100 (PERF.md, PR 7)."""
    for i, mat in enumerate(params["matrices"]):
        logits = (F.softplus(mat)[..., None] * logits[:, None]).sum(2) \
            + params["biases"][i]
        if i < len(params["factors"]):
            logits = logits + torch.tanh(params["factors"][i]) * torch.tanh(
                logits)
    return logits


class _LowerBound(torch.autograd.Function):
    """max(x, bound) whose gradient also passes where it pushes x up from
    below the bound (g < 0)."""

    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def _likelihood(params: Dict, xt: torch.Tensor,
                q_step: float) -> torch.Tensor:
    """sigmoid(c(x + Q/2)) - sigmoid(c(x - Q/2)), evaluated on the side of
    the sigmoid's centre where it does not lose precision (sign's
    gradient is zero, as the JAX package's stop_gradient makes it)."""
    lower = _logits_cumulative(params, xt - 0.5 * q_step)
    upper = _logits_cumulative(params, xt + 0.5 * q_step)
    sign = -torch.sign(lower + upper)
    return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))


def factorized_bits(params: Dict, x: torch.Tensor,
                    q_step: float) -> torch.Tensor:
    """x [N, C] quantized values -> estimated bits [N, C]."""
    likelihood = _likelihood(params, x.T[:, None, :], q_step)
    bits = -torch.log2(lower_bound(likelihood, LIKELIHOOD_BOUND))
    return bits[:, 0, :].T


def factorized_likelihood_table(params: Dict, symbols: torch.Tensor,
                                q_step: float,
                                lower_bd: float) -> torch.Tensor:
    """The PMF over integer symbol levels [L] for arithmetic coding:
    [C, L] probabilities."""
    x = lower_bd + symbols.to(torch.float32) * q_step
    C = params["matrices"][0].shape[0]
    xt = x[None, None, :].expand(C, 1, x.shape[0])
    likelihood = _likelihood(params, xt, q_step)
    return torch.clamp(likelihood[:, 0, :], min=LIKELIHOOD_BOUND)
