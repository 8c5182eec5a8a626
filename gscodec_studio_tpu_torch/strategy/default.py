"""The 3DGS default densification strategy at a static capacity (port of
gscodec_studio_tpu/strategy/default.py): screen-space gradient
accumulation, duplicate and split growth into free slots, opacity and
scale pruning, and the periodic opacity reset."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gscodec_studio_tpu_torch.models.splats import DEAD_OPACITY_LOGIT
from gscodec_studio_tpu_torch.strategy import ops
from gscodec_studio_tpu_torch.strategy.base import Strategy


@dataclass(frozen=True)
class DefaultStrategy(Strategy):
    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    refine_scale2d_stop_iter: int = 0
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    absgrad: bool = False
    revised_opacity: bool = False

    def initialize_state(self, cap: int, scene_scale: float, device=None):
        z = lambda: torch.zeros(cap, dtype=torch.float32, device=device)
        return {"grad2d": z(), "count": z(), "radii": z(),
                "scene_scale": torch.tensor(scene_scale, dtype=torch.float32,
                                            device=device)}

    def update_state(self, state, info, v_means2d):
        """Accumulate the normalised screen-space gradient norm of every
        visible slot. ``v_means2d`` [C, cap, 2] is dL/d means2d (with
        absgrad: the |per-pixel| sums)."""
        width, height, C = info["width"], info["height"], info["n_cameras"]
        radii = info["radii"]  # [C, cap]
        sel = radii > 0
        g = v_means2d * torch.tensor([width / 2.0 * C, height / 2.0 * C],
                                     dtype=v_means2d.dtype,
                                     device=v_means2d.device)
        norm = torch.linalg.vector_norm(g, dim=-1)  # [C, cap]
        state = dict(state)
        state["grad2d"] = state["grad2d"] + torch.where(
            sel, norm, torch.zeros_like(norm)).sum(0)
        state["count"] = state["count"] + sel.sum(0).to(torch.float32)
        if self.refine_scale2d_stop_iter > 0:
            r = torch.where(sel, radii, torch.zeros_like(radii)).amax(0).to(
                torch.float32) / max(width, height)
            state["radii"] = torch.maximum(state["radii"], r)
        return state

    def refine(self, params, opt_states, state, step,
               generator: Optional[torch.Generator] = None,
               split_samples: Optional[torch.Tensor] = None):
        """Grow (duplicate, then split) and prune; resets the accumulators.
        The split's standard-normal draws [2, cap, 3] come from
        ``split_samples`` when given, else from ``generator``."""
        cap = params["opacities"].shape[0]
        if split_samples is None:
            split_samples = torch.randn((2, cap, 3), generator=generator,
                                        device=params["means"].device)
        alive = params["opacities"] > DEAD_OPACITY_LOGIT + 1.0
        free = ~alive
        grads = state["grad2d"] / torch.clamp(state["count"], min=1.0)
        is_grad_high = grads > self.grow_grad2d
        is_small = (torch.exp(params["scales"]).amax(-1)
                    <= self.grow_scale3d * state["scene_scale"])
        is_dupli = is_grad_high & is_small & alive
        is_split = is_grad_high & ~is_small & alive
        if self.refine_scale2d_stop_iter > 0:
            is_split |= (state["radii"] > self.grow_scale2d) & alive

        dst, _ = ops.allocate_slots(free, is_dupli)
        params, opt_states = ops.copy_to_slots(params, opt_states, dst)
        # the duplicates now hold live opacities: recompute the free pool
        free = params["opacities"] <= DEAD_OPACITY_LOGIT + 1.0
        dst2, _ = ops.allocate_slots(free, is_split)
        params, opt_states = ops.split_to_slots(
            params, opt_states, is_split, dst2, split_samples,
            self.revised_opacity)

        op = torch.sigmoid(params["opacities"])
        is_prune = (op < self.prune_opa) & alive
        if step > self.reset_every:
            is_too_big = (torch.exp(params["scales"]).amax(-1)
                          > self.prune_scale3d * state["scene_scale"])
            is_prune |= is_too_big & alive
        params, opt_states = ops.remove_slots(params, opt_states, is_prune)

        state = dict(state)
        for k in ("grad2d", "count", "radii"):
            state[k] = torch.zeros_like(state[k])
        return params, opt_states, state

    def maybe_reset_opacity(self, params, opt_states, step):
        """The opacity reset; the trainer calls it every ``reset_every``
        steps."""
        alive = params["opacities"] > DEAD_OPACITY_LOGIT + 1.0
        return ops.reset_opacities(params, opt_states, 2 * self.prune_opa,
                                   alive)
