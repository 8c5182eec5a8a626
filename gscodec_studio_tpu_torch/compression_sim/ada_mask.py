"""The temperature-annealed learnable sparsity mask over shN (port of
gscodec_studio_tpu/compression_sim/ada_mask.py): sigmoid(logits / T), T
decaying exponentially from start_temp to end_temp after
annealing_start_iter; its loss is l1 * mean(mask) plus a target BCE."""

from __future__ import annotations

import torch


def annealing_temperature(step: int, total_iters: int = 30_000,
                          start_temp: float = 5.0, end_temp: float = 0.1,
                          annealing_start_iter: int = 10_000
                          ) -> torch.Tensor:
    """The temperature at ``step``, a float32 scalar tensor computed in
    float32 as the JAX package does."""
    f32 = torch.float32
    progress = torch.clamp(
        torch.tensor(step - annealing_start_iter, dtype=f32)
        / torch.tensor(total_iters - annealing_start_iter, dtype=f32),
        0.0, 1.0)
    log_ratio = torch.log(torch.tensor(end_temp / start_temp, dtype=f32))
    temp = start_temp * torch.exp(log_ratio * progress)
    if step < annealing_start_iter:
        return torch.tensor(start_temp, dtype=f32)
    return temp


def annealing_mask_apply(mask_logits: torch.Tensor, x: torch.Tensor,
                         step: int, training: bool = True,
                         **temp_kw) -> torch.Tensor:
    """x [N, K, 3] times the soft (training) or hard (eval) mask [N]."""
    if training:
        t = annealing_temperature(step, **temp_kw).to(mask_logits.device)
        mask = torch.sigmoid(mask_logits / t)
    else:
        mask = binary_mask(mask_logits).to(x.dtype)
    return x * mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def annealing_mask_sparsity_loss(mask_logits: torch.Tensor, step: int,
                                 lambda_l1: float = 0.01,
                                 lambda_target: float = 0.1,
                                 target_sparsity: float = 0.2,
                                 **temp_kw) -> torch.Tensor:
    t = annealing_temperature(step, **temp_kw).to(mask_logits.device)
    mask = torch.sigmoid(mask_logits / t)
    l1 = lambda_l1 * mask.mean()
    s = torch.clamp(mask.mean(), 1e-6, 1 - 1e-6)
    bce = -(target_sparsity * torch.log(s)
            + (1 - target_sparsity) * torch.log(1 - s))
    return l1 + lambda_target * bce


def binary_mask(mask_logits: torch.Tensor) -> torch.Tensor:
    return (torch.sigmoid(mask_logits) >= 0.5).to(torch.float32)
