"""The MCMC densification strategy, "3DGS as Markov Chain Monte Carlo", at
a static capacity (port of gscodec_studio_tpu/strategy/mcmc.py).

The tensors are allocated at ``cap_max`` from the start, and an
``allocated`` mask marks the slots of the reference's growing tensor. A
refine relocates the dead allocated slots onto live Gaussians sampled by
opacity and grows the allocated set by 5%, the new slots relocated the same
way; every step the trainer adds position noise to near-transparent
Gaussians.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gscodec_studio_tpu_torch.strategy import ops
from gscodec_studio_tpu_torch.strategy.base import Strategy


@dataclass(frozen=True)
class MCMCStrategy(Strategy):
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100
    min_opacity: float = 0.005
    grow_factor: float = 1.05

    def initialize_state(self, cap: int, scene_scale: float,
                         n_init: Optional[int] = None, device=None):
        n_init = cap if n_init is None else n_init
        return {"allocated": torch.arange(cap, device=device) < n_init,
                "scene_scale": torch.tensor(scene_scale, dtype=torch.float32,
                                            device=device)}

    def update_state(self, state, info, v_means2d):
        return state

    def refine(self, params, opt_states, state, step,
               generator: Optional[torch.Generator] = None,
               sampled: Optional[torch.Tensor] = None):
        """Relocate the dead allocated slots and grow the allocated set to
        ceil(1.05 * n_allocated) (at most cap), the new slots first in slot
        order: one relocation pass over their union. The sources
        (int64 [cap]) come from ``sampled`` when given, else
        ops.sample_sources with ``generator``."""
        del step
        cap = params["opacities"].shape[0]
        allocated = state["allocated"]
        op = torch.sigmoid(params["opacities"])
        dead_alloc = allocated & (op <= self.min_opacity)
        n_alloc = allocated.sum().to(torch.float32)
        # in float32, as the JAX package computes it
        n_target = torch.clamp(torch.ceil(n_alloc * self.grow_factor),
                               max=cap).to(torch.int64)
        n_grow = torch.clamp(n_target - allocated.sum(), min=0)
        unalloc = ~allocated
        grow = unalloc & (torch.cumsum(unalloc.to(torch.int64), 0) - 1
                          < n_grow)
        relocate = dead_alloc | grow
        if sampled is None:
            sampled = ops.sample_sources(params["opacities"], relocate,
                                         generator)
        params, opt_states = ops.relocate_dead(
            params, opt_states, sampled, relocate, self.min_opacity)
        return params, opt_states, dict(state, allocated=allocated | grow)

    def inject_noise(self, params, noise: torch.Tensor, lr: float):
        """Per-step position noise; ``noise`` is standard normal [cap, 3]."""
        return ops.inject_noise_to_position(params, noise, lr, self.noise_lr,
                                            self.min_opacity)
