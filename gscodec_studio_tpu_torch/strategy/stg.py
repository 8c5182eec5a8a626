"""SpacetimeGaussian densification strategies at a static capacity (port
of gscodec_studio_tpu/strategy/stg.py): the default strategy's grow and
prune, plus

  * a densification budget: a splat densified ``desicnt`` times no longer
    counts as a high-gradient one (state ``densify_count``);
  * the omega freeze: from ``freeze_start_iter`` on, omega (the rotation
    velocity) stays live only for high-motion (sum |motion[:3]| > 0.3),
    mid-scale (0.2 < max scale < 0.6), opaque (sigmoid(opacity) > 0.7)
    splats; the mask (state ``omega_keep``) is refreshed after every
    refine, the frozen omegas are zeroed, and the trainer masks omega's
    gradients by it and the rotations' by its complement
    (``mask_gradients``);
  * z and world-bounds pruning (``prune_bounds``).

``ModifiedSTGStrategy`` counts a splat's screen-space gradient only at the
timestamps where it is temporally visible (``t_vis_mask`` in the render's
meta) and never freezes omega.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gscodec_studio_tpu_torch.models.splats import DEAD_OPACITY_LOGIT
from gscodec_studio_tpu_torch.strategy import ops
from gscodec_studio_tpu_torch.strategy.default import DefaultStrategy


@dataclass(frozen=True)
class STGStrategy(DefaultStrategy):
    desicnt: int = 6  # densifications a splat may take
    zmask_every: int = 1000
    z_far: float = 4.5
    freeze_start_iter: int = 8001
    omega_motion_threshold: float = 0.3
    omega_scale_min: float = 0.2
    omega_scale_max: float = 0.6
    omega_opacity_min: float = 0.7

    def initialize_state(self, cap: int, scene_scale: float, device=None):
        state = super().initialize_state(cap, scene_scale, device=device)
        state["densify_count"] = torch.zeros(cap, dtype=torch.int32,
                                             device=device)
        # every omega kept until the freeze
        state["omega_keep"] = torch.ones(cap, dtype=torch.bool,
                                         device=device)
        return state

    def compute_omega_mask(self, params) -> torch.Tensor:
        """The rows whose omega stays live: high motion, mid scale,
        opaque."""
        smax = torch.exp(params["scales"]).amax(-1)
        motion_sum = params["motion"][:, :3].abs().sum(-1)
        opac = torch.sigmoid(params["opacities"])
        return ((motion_sum > self.omega_motion_threshold)
                & (smax > self.omega_scale_min)
                & (smax < self.omega_scale_max)
                & (opac > self.omega_opacity_min))

    def apply_omega_freeze(self, params, state):
        """Stores the mask and zeroes the frozen omegas."""
        mask = self.compute_omega_mask(params)
        params = dict(params)
        params["omega"] = params["omega"] * mask[:, None].to(
            params["omega"].dtype)
        return params, dict(state, omega_keep=mask)

    def _budgeted_refine(self, refine, params, opt_states, state, step,
                         generator, split_samples):
        """``refine`` (the default strategy's) with the splats whose
        densification budget is spent taken out of the high-gradient
        ones; counts the densified rows."""
        budget_ok = state["densify_count"] < self.desicnt
        grads_masked = torch.where(budget_ok, state["grad2d"],
                                   torch.zeros_like(state["grad2d"]))
        densified = grads_masked / torch.clamp(state["count"], min=1.0) \
            > self.grow_grad2d
        params, opt_states, inner = refine(
            params, opt_states, dict(state, grad2d=grads_masked), step,
            generator=generator, split_samples=split_samples)
        state = dict(state, **{k: inner[k] for k in ("grad2d", "count",
                                                     "radii")})
        state["densify_count"] = state["densify_count"] + densified.to(
            torch.int32)
        return params, opt_states, state

    def refine(self, params, opt_states, state, step,
               generator: Optional[torch.Generator] = None,
               split_samples: Optional[torch.Tensor] = None):
        """The budgeted grow and prune; from freeze_start_iter on, the
        omega mask refreshed on the refined slots."""
        params, opt_states, state = self._budgeted_refine(
            super().refine, params, opt_states, state, step, generator,
            split_samples)
        if step >= self.freeze_start_iter:
            params, state = self.apply_omega_freeze(params, state)
        return params, opt_states, state

    def mask_gradients(self, params, grads, step: int, state=None):
        """After the freeze: omega's gradients times the keep mask, the
        rotations' times its complement (the mask recomputed where the
        state holds none)."""
        if "omega" not in grads or step < self.freeze_start_iter:
            return grads
        if state is not None and "omega_keep" in state:
            keep = state["omega_keep"]
        else:
            keep = self.compute_omega_mask(params)
        keep_f = keep.to(torch.float32)
        grads = dict(grads)
        grads["omega"] = grads["omega"] * keep_f[:, None]
        grads["quats"] = grads["quats"] * (1.0 - keep_f)[:, None]
        return grads

    def prune_bounds(self, params, opt_states, maxbounds=None,
                     minbounds=None, z_far=None):
        """Kills the live splats beyond z_far or outside the world
        bounds."""
        means = params["means"]
        kill = means[:, 2] > (z_far or self.z_far)
        if maxbounds is not None:
            kill |= (means > torch.as_tensor(
                maxbounds, dtype=means.dtype, device=means.device)).any(-1)
        if minbounds is not None:
            kill |= (means < torch.as_tensor(
                minbounds, dtype=means.dtype, device=means.device)).any(-1)
        alive = params["opacities"] > DEAD_OPACITY_LOGIT + 1.0
        return ops.remove_slots(params, opt_states, kill & alive)


@dataclass(frozen=True)
class ModifiedSTGStrategy(STGStrategy):
    """Temporal-visibility-aware statistics and no omega freeze."""

    def update_state(self, state, info, v_means2d):
        """The default accumulation over the (camera, splat) pairs that
        are temporally visible at the rendered timestamps: the radii of
        the others are zeroed before the default strategy reads them."""
        t_vis = info.get("t_vis_mask")  # [C, N] or [N] bool
        if t_vis is not None:
            radii = info["radii"]
            if t_vis.ndim == 1:
                t_vis = t_vis[None, :].expand(radii.shape)
            info = dict(info, radii=torch.where(t_vis, radii,
                                                torch.zeros_like(radii)))
        return super().update_state(state, info, v_means2d)

    def mask_gradients(self, params, grads, step: int, state=None):
        return grads

    def refine(self, params, opt_states, state, step,
               generator: Optional[torch.Generator] = None,
               split_samples: Optional[torch.Tensor] = None):
        return self._budgeted_refine(
            super(STGStrategy, self).refine, params, opt_states, state,
            step, generator, split_samples)
