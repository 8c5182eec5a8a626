"""2DGS trainer (port of gscodec_studio_tpu/training/trainer_2dgs.py):
surfel splats with the normal-consistency and distortion losses.

The static trainer's loop, with ``rendering.rasterization_2dgs`` as the
render and the loss
  combined_loss(render, target)
  + normal_lambda * (step > normal_start_iter)
    * mean(1 - <normalize(render_normals), surf_normals>)
  + dist_lambda * (step > dist_start_iter) * mean(render_distort).
Densification (the default or the MCMC strategy), Adam, the finite gate,
the capacity and evaluation are the 3DGS ``Runner``'s. Five behaviours of
the JAX Runner2DGS are reproduced, not repaired: its strategy reads a zero
means2d gradient (so the default strategy's refines only prune and
reset), its loss drops ``opacity_reg``, ``scale_reg`` and ``random_bkgd``,
the median depth carries no gradient, under MCMC it relocates and grows
but adds no position noise, and with ``visible_adam`` its SelectiveAdam
gets no visibility and so updates every row. It refuses
``compression_sim``, which the JAX Runner2DGS carries without applying,
and the per-image modules (``pose_opt``, ``app_opt``,
``use_bilateral_grid``, ``depth_loss``), which its step never applies. The JAX Runner2DGS passes none of
``grad_dtype``, ``attr_dtype`` and ``log_composite`` to its render; this one
ignores them too, and names those set off their defaults once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gscodec_studio_tpu_torch.models.splats import splat_activations
from gscodec_studio_tpu_torch.rendering import rasterization_2dgs
from gscodec_studio_tpu_torch.training.losses import combined_loss
from gscodec_studio_tpu_torch.training.trainer import (Config, Runner,
                                                       _tensor)


@dataclass
class Config2DGS(Config):
    normal_lambda: float = 5e-2
    normal_start_iter: int = 7_000
    dist_lambda: float = 1e-2
    dist_start_iter: int = 3_000


class Runner2DGS(Runner):
    """The 3DGS Runner with the 2DGS render and loss. ``cfg.rasterizer``
    "fused" selects the 2DGS tile kernels; "reference" and "pallas" the
    plain oracle (the only other 2DGS backend), as in the JAX package."""

    rasterizers = ("fused", "pallas", "reference")
    # The JAX Runner2DGS's step never calls inject_noise
    # (gscodec_studio_tpu/training/trainer_2dgs.py:47-108): under MCMC its
    # surfels relocate and grow but do not random-walk. Reproduced, not
    # repaired.
    injects_noise = False
    has_mesh_mode = False  # the JAX Runner2DGS has none either

    def _visibility(self, meta) -> torch.Tensor:
        """Every row: the JAX Runner2DGS builds SelectiveAdam groups under
        visible_adam but applies them with no visibility
        (gscodec_studio_tpu/training/trainer_2dgs.py:90-92), which the
        optimizer reads as all rows seen. Reproduced, not repaired."""
        return torch.ones(meta["radii"].shape[1], dtype=torch.bool,
                          device=self.device)

    def __init__(self, cfg, *args, **kwargs):
        if cfg.compression_sim:
            raise NotImplementedError(
                "compression_sim in Runner2DGS (the JAX Runner2DGS carries "
                "the simulation's state but its step never applies it) is "
                "not ported: ROADMAP watch-list")
        # the JAX Runner2DGS builds these modules but its step
        # (gscodec_studio_tpu/training/trainer_2dgs.py:114) never applies
        # them
        for name in ("pose_opt", "app_opt", "use_bilateral_grid",
                     "depth_loss"):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"{name} in Runner2DGS (the JAX Runner2DGS's step never "
                    f"applies it) is not ported: ROADMAP watch-list")
        super().__init__(cfg, *args, **kwargs)

    def _name_ignored(self) -> None:
        cfg = self.cfg
        ignored = [what for on, what in (
            (cfg.grad_dtype != "f32", f"grad_dtype={cfg.grad_dtype!r}"),
            (cfg.attr_dtype != "f32", f"attr_dtype={cfg.attr_dtype!r}"),
            (cfg.log_composite, "log_composite=True"),
        ) if on]
        if ignored:
            print("Runner2DGS: ignored, as the JAX Runner2DGS ignores them: "
                  + ", ".join(ignored), flush=True)

    def _rasterizer_2dgs(self) -> str:
        return "fused" if self.cfg.rasterizer == "fused" else "reference"

    def render_loss(self, params, c2w, Ks, target, sh_degree: int,
                    step: int, aux=None, view=None):
        del aux, view  # no per-image modules (refused above)
        cfg = self.cfg
        dev = self.device
        B, H, W = target.shape[:3]
        means, quats, scales, opac = splat_activations(params)
        colors = torch.cat([params["sh0"], params["shN"]], 1)
        (render, _, render_n, surf_n, distort, _, meta) = rasterization_2dgs(
            means, quats, scales, opac, colors, torch.linalg.inv(c2w), Ks,
            W, H, sh_degree=sh_degree, near_plane=cfg.near_plane,
            far_plane=cfg.far_plane, rasterizer=self._rasterizer_2dgs(),
            isect_capacity=self.isect_capacity(), device=dev)
        # The JAX Runner2DGS never feeds its probe to the rasterizer: it
        # adds 0 * probe.sum() to the render
        # (gscodec_studio_tpu/training/trainer_2dgs.py:67), so the
        # v_means2d it hands the strategy (:89) is identically zero, the
        # default strategy's grad2d never grows, and refines only prune and
        # reset. Reproduced, not repaired.
        probe = torch.zeros((B, means.shape[0], 2), device=dev,
                            requires_grad=True)
        render = render + 0.0 * probe.sum()
        loss = combined_loss(render, target, cfg.ssim_lambda)
        gate_n = float(step > cfg.normal_start_iter)
        # the camera-frame splat normal field against the depth's normals
        nc = render_n * torch.rsqrt(torch.clamp(
            (render_n * render_n).sum(-1, keepdim=True), min=1e-12))
        normal_err = 1.0 - (nc * surf_n).sum(-1)
        loss = loss + cfg.normal_lambda * gate_n * normal_err.mean()
        gate_d = float(step > cfg.dist_start_iter)
        loss = loss + cfg.dist_lambda * gate_d * distort.mean()
        return loss, meta, probe

    def render_view(self, camtoworld, K, width: int, height: int,
                    sh_degree: Optional[int] = None) -> torch.Tensor:
        """[H, W, 3] render of the current splats, clipped to [0, 1]."""
        sh = self.cfg.sh_degree if sh_degree is None else sh_degree
        dev = self.device
        with torch.no_grad():
            means, quats, scales, opac = splat_activations(self.splats)
            colors = torch.cat([self.splats["sh0"], self.splats["shN"]], 1)
            viewmat = torch.linalg.inv(_tensor(camtoworld, dev))
            render, *_ = rasterization_2dgs(
                means, quats, scales, opac, colors, viewmat[None],
                _tensor(K, dev)[None], width, height, sh_degree=sh,
                rasterizer=self._rasterizer_2dgs(),
                isect_capacity=self.isect_capacity(), device=dev)
        return torch.clamp(render[0, ..., :3], 0.0, 1.0)
