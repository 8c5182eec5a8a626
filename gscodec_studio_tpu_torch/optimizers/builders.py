"""Per-parameter-group Adam (port of
gscodec_studio_tpu/optimizers/builders.py): the per-name learning rates of
PARAM_LRS scaled by sqrt(batch), eps 1e-15/sqrt(batch), batch-scaled betas,
and an exponential decay of the means' rate to 0.01x over max_steps.

The Adam is functional over explicit moments, optax's arithmetic step for
step, so that the densification ops can edit the moments row by row: each
group's state is {"count": updates so far, "exp_avg": first moment,
"exp_avg_sq": second moment}, the tensors with the parameter's shape.
With ``visible_adam`` the groups are SelectiveAdam
(optimizers/selective_adam.py), in the same state layout: its step takes
the rows' visibility and updates the parameter and the moments in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.models.splats import PARAM_LRS
from gscodec_studio_tpu_torch.optimizers.selective_adam import (
    selective_adam_step)


@dataclass(frozen=True)
class AdamGroup:
    lr: float
    b1: float
    b2: float
    eps: float
    decay_steps: Optional[int] = None  # lr * 0.01 ** (count / decay_steps)
    selective: bool = False  # SelectiveAdam: raw moments, rows masked
    weight_decay: float = 0.0  # optax.adamw's: added to the update

    def lr_at(self, count: int) -> float:
        if self.decay_steps is None:
            return self.lr
        return self.lr * 0.01 ** (count / self.decay_steps)


def build_splat_optimizers(
    params: Dict[str, torch.Tensor],
    scene_scale: float = 1.0,
    batch_size: int = 1,
    max_steps: int = 30_000,
    visible_adam: bool = False,
) -> Tuple[Dict[str, AdamGroup], Dict[str, dict]]:
    """Returns ({name: AdamGroup}, {name: state}); with ``visible_adam``
    the groups are SelectiveAdam."""
    bs = batch_size
    sqrt_bs = math.sqrt(bs)
    b1 = 1 - bs * (1 - 0.9)
    b2 = 1 - bs * (1 - 0.999)
    eps = 1e-15 / sqrt_bs
    groups, states = {}, {}
    for name, p in params.items():
        lr = PARAM_LRS.get(name, 1e-3) * sqrt_bs
        decay = None
        if name == "means":
            lr = lr * scene_scale
            decay = max_steps
        groups[name] = AdamGroup(lr, b1, b2, eps, decay, visible_adam)
        states[name] = adam_state(p)
    return groups, states


def adam_state(p: torch.Tensor) -> dict:
    """A group's state before its first step: count 0, zero moments."""
    return {"count": 0, "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}


def adam_update(group: AdamGroup, state: dict, p: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One Adam step of one group, in optax's order of operations (with
    ``weight_decay``, optax.adamw's: the decay times the parameter added to
    the update before the rate scales it)."""
    count = state["count"]
    mu = (1 - group.b1) * g + group.b1 * state["exp_avg"]
    nu = (1 - group.b2) * (g * g) + group.b2 * state["exp_avg_sq"]
    c = count + 1
    mu_hat = mu / (1 - group.b1 ** c)
    nu_hat = nu / (1 - group.b2 ** c)
    upd = mu_hat / (torch.sqrt(nu_hat) + group.eps)
    if group.weight_decay:
        upd = upd + group.weight_decay * p
    new_p = p + (-group.lr_at(count)) * upd
    return new_p, {"count": c, "exp_avg": mu, "exp_avg_sq": nu}


def apply_updates(groups, states, params, grads,
                  visibility: Optional[torch.Tensor] = None,
                  visible_adam: bool = False):
    """One optimizer step over the per-name groups -> (params, states).
    ``visibility`` [cap] is consumed only with ``visible_adam``, by the
    SelectiveAdam groups, which update their tensors in place and read
    their rate at count + 1."""
    if visible_adam and visibility is None:
        raise ValueError("visible_adam needs the rows' visibility")
    new_params, new_states = {}, {}
    for name, p in params.items():
        group, state = groups[name], states[name]
        if visible_adam and group.selective:
            c = state["count"] + 1
            selective_adam_step(p, grads[name], state["exp_avg"],
                                state["exp_avg_sq"], visibility,
                                group.lr_at(c), group.b1, group.b2,
                                group.eps)
            new_params[name] = p
            new_states[name] = dict(state, count=c)
        else:
            new_params[name], new_states[name] = adam_update(
                group, state, p, grads[name])
    return new_params, new_states
