"""Static 3DGS trainer (port of gscodec_studio_tpu/training/trainer.py):
``Config`` with every field of the JAX package's, and a ``Runner`` that
trains on one CUDA card with the default or the MCMC strategy, optionally
under the compression simulation (the garden ladder's recipe).

A step: the compression simulation (fake quantization, entropy bits, the
shN mask) -> activations -> ``rendering.rasterization`` (projection, SH,
binning and the rasterizer's forward and backward kernels: the fused
backend, its gradient rows in f32 or packed bf16 pairs, or by
``cfg.rasterizer`` the legacy v1 kernels or the dense oracle) -> L1 +
SSIM loss (these two in ``Runner.render_loss``, which the 2DGS runner
overrides), the regularisers and rd_lambda * bits -> autograd -> the
densification statistics from the means2d probe's gradient -> per-group
Adam, the sim parameters' Adam, and with MCMC the position noise. A
finite-step gate skips a step whose loss or any gradient is not finite
and counts it. Between steps the loop runs the strategy's refine (and the
default strategy's opacity reset), the SH-degree schedule and the
adaptive intersection capacity.

The port loops in Python, one step per iteration; the JAX package's
``lax.scan`` chunks (``steps_per_dispatch``) were a TPU dispatch device.
The options of later slices raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from gscodec_studio_tpu_torch.compression_sim import CompressionSimulation
from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.models.splats import (create_splats, num_live,
                                                    splat_activations)
from gscodec_studio_tpu_torch.optimizers import (apply_updates,
                                                 build_splat_optimizers)
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.strategy import DefaultStrategy, MCMCStrategy
from gscodec_studio_tpu_torch.training.losses import (combined_loss, psnr,
                                                      ssim)


@dataclass
class Config:
    """The JAX package's Config, field for field and default for default.
    Fields of options that are not ported yet are accepted at their
    defaults; ``Runner`` raises for any other value, except save_steps,
    tb_every and skip_probe, which it names once as ignored."""

    data_dir: str = "data/garden"
    data_factor: int = 4
    result_dir: str = "results/run"
    max_steps: int = 30_000
    batch_size: int = 1
    test_every: int = 8

    # Model
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_type: str = "sfm"
    init_num_pts: int = 100_000
    init_opa: float = 0.1
    init_scale: float = 1.0
    near_plane: float = 0.01
    far_plane: float = 1e10
    antialiased: bool = False

    # Capacity (static shapes): the default strategy grows into cap slots.
    capacity: Optional[int] = None  # default: 4x the initial points
    isect_capacity: Optional[int] = None

    # Loss
    ssim_lambda: float = 0.2
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    random_bkgd: bool = False

    # Strategy: "default" | "mcmc"
    strategy: str = "default"
    mcmc_cap_max: int = 1_000_000
    refine_start_iter: Optional[int] = None
    refine_stop_iter: Optional[int] = None
    refine_every: Optional[int] = None

    # Camera pose, appearance, bilateral grid, depth loss (not ported yet)
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    app_opt: bool = False
    app_embed_dim: int = 16
    app_feature_dim: int = 32
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    use_bilateral_grid: bool = False
    bilagrid_shape: tuple = (8, 16, 16)
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    depth_points_cap: int = 512

    # Observability (TensorBoard logging is not ported)
    tb_every: int = 100
    tb_histograms_every: int = 0
    eval_save_images: bool = False

    # Misc
    eval_steps: tuple = (7_000, 30_000)
    save_steps: tuple = (7_000, 30_000)
    seed: int = 42
    visible_adam: bool = False
    skip_probe: bool = True
    # the JAX package's scan length; the port runs one step per iteration
    # and ignores it
    steps_per_dispatch: int = 25

    # Rasterizer backend: "fused", "pallas" (legacy v1) or "reference"
    rasterizer: str = "fused"
    tile_size: int = 16
    cutoff_mode: str = "soft"
    grad_dtype: str = "f32"
    attr_dtype: str = "f32"
    log_composite: bool = False
    isect_cap_max_scale: int = 4

    # Multi-device training (not ported yet)
    mesh_devices: int = 0
    exchange_cap: Optional[int] = None

    # Compression simulation ("gaussian_model" is not ported yet)
    compression_sim: bool = False
    rd_lambda: float = 0.01
    entropy_model_opt: bool = False
    entropy_model_type: str = "factorized_model"
    shN_ada_mask_opt: bool = False


def check_ported(cfg: Config, rasterizers=("fused",)) -> None:
    """Raise NotImplementedError for an option of a later slice."""
    later = [
        (cfg.visible_adam, "visible_adam (SelectiveAdam)", "A6"),
        (cfg.init_type != "sfm", f"init_type={cfg.init_type!r}", "A9"),
        (cfg.compression_sim and cfg.entropy_model_opt
         and cfg.entropy_model_type == "gaussian_model",
         "entropy_model_type='gaussian_model' (hash_grid.py)", "A7"),
        (cfg.pose_opt, "pose_opt", "A8"),
        (cfg.app_opt, "app_opt", "A8"),
        (cfg.use_bilateral_grid, "use_bilateral_grid", "A8"),
        (cfg.depth_loss, "depth_loss", "A8"),
        (cfg.mesh_devices > 1, f"mesh_devices={cfg.mesh_devices}", "A12"),
        (cfg.rasterizer not in rasterizers, f"rasterizer={cfg.rasterizer!r}",
         "A13"),
        (cfg.eval_save_images, "eval_save_images", "A8"),
        (cfg.tb_histograms_every != 0,
         f"tb_histograms_every={cfg.tb_histograms_every}", "A8"),
    ]
    for bad, what, item in later:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP {item}")
    if cfg.strategy not in ("default", "mcmc"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r}")
    if cfg.attr_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown attr_dtype {cfg.attr_dtype!r}")
    unhonoured = [what for on, what in (
        (bool(cfg.save_steps), f"save_steps={tuple(cfg.save_steps)} "
                               "(checkpoints)"),
        (cfg.tb_every != 0, f"tb_every={cfg.tb_every} (TensorBoard scalars)"),
        (cfg.skip_probe, "skip_probe=True (skipped-step fingerprints)"),
    ) if on]
    if unhonoured:
        print("Runner: not ported yet, ignored (ROADMAP A8): "
              + ", ".join(unhonoured), flush=True)


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor)
                           else np.asarray(x, np.float32),
                           dtype=torch.float32, device=dev)


class Runner:
    """Trains a 3DGS scene. ``parser`` gives ``points`` [N, 3],
    ``points_rgb`` [N, 3] in 0..255 and ``scene_scale``; the datasets give
    dicts with "camtoworld", "K" and "image" [H, W, 3] in [0, 1]."""

    # the cfg.rasterizer values this runner takes
    rasterizers = ("fused", "pallas", "reference")
    injects_noise = True  # MCMC's per-step position noise

    def __init__(self, cfg: Config, parser=None, trainset=None, valset=None,
                 device: DeviceLike = None):
        check_ported(cfg, self.rasterizers)
        if parser is None:
            raise NotImplementedError(
                "the COLMAP dataset loader is not ported yet: ROADMAP A9; "
                "pass parser, trainset and valset")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.parser, self.trainset, self.valset = parser, trainset, valset
        self.scene_scale = float(getattr(parser, "scene_scale", 1.0))
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)

        points = np.asarray(parser.points, np.float32)
        rgbs = np.asarray(parser.points_rgb, np.float32) / 255.0
        n_init = points.shape[0]
        if cfg.strategy == "mcmc":
            cap = cfg.mcmc_cap_max
            strategy = MCMCStrategy(cap_max=cap)
        else:
            cap = cfg.capacity or 4 * n_init
            strategy = DefaultStrategy()
        cap = max(cap, n_init)
        overrides = {k: int(getattr(cfg, k)) for k in (
            "refine_start_iter", "refine_stop_iter", "refine_every")
            if getattr(cfg, k) is not None}
        self.strategy = replace(strategy, **overrides)
        self.splats = create_splats(
            points, rgbs, cap=cap, sh_degree=cfg.sh_degree,
            init_opacity=cfg.init_opa, init_scale=cfg.init_scale,
            generator=self.generator, device=dev)
        self.groups, self.opt_states = build_splat_optimizers(
            self.splats, scene_scale=self.scene_scale,
            batch_size=cfg.batch_size, max_steps=cfg.max_steps)
        if cfg.strategy == "mcmc":
            self.strategy_state = self.strategy.initialize_state(
                cap, self.scene_scale, n_init=n_init, device=dev)
        else:
            self.strategy_state = self.strategy.initialize_state(
                cap, self.scene_scale, device=dev)
        self.compression_sim = None
        self.sim_params: Dict[str, torch.Tensor] = {}
        self.sim_groups, self.sim_states = {}, {}
        if cfg.compression_sim:
            self.compression_sim = CompressionSimulation(
                entropy_model_opt=cfg.entropy_model_opt,
                shN_ada_mask_opt=cfg.shN_ada_mask_opt,
                entropy_model_type=cfg.entropy_model_type, cap=cap,
                max_steps=cfg.max_steps)
            sim_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
            self.sim_params = self.compression_sim.init_params(sim_gen, dev)
            self.sim_groups, self.sim_states = \
                self.compression_sim.build_optimizer(self.sim_params)
        n_train = len(trainset) if trainset is not None else 0
        # host-side ordering, the JAX Runner's own draw (not a device draw)
        self.view_order = np.random.default_rng(cfg.seed).permutation(
            n_train).tolist()
        self.skipped_steps = 0
        self.isect_cap_scale = 1
        self.events: List[dict] = []  # refines, resets, capacity changes
        self._data = None
        os.makedirs(cfg.result_dir, exist_ok=True)
        self._name_ignored()

    def _name_ignored(self) -> None:
        """Names once the fused backend's options that cfg sets off their
        defaults while another backend renders: rendering.rasterization
        ignores them there, as the JAX package does."""
        cfg = self.cfg
        ignored = [what for on, what in (
            (cfg.cutoff_mode != "soft", f"cutoff_mode={cfg.cutoff_mode!r}"),
            (cfg.grad_dtype != "f32", f"grad_dtype={cfg.grad_dtype!r}"),
            (cfg.attr_dtype != "f32", f"attr_dtype={cfg.attr_dtype!r}"),
            (cfg.log_composite, "log_composite=True"),
        ) if on]
        if ignored and cfg.rasterizer != "fused":
            print(f"Runner: ignored under rasterizer={cfg.rasterizer!r}, as "
                  "in the JAX package: " + ", ".join(ignored), flush=True)

    # -- one step ----------------------------------------------------------

    def _device_trainset(self) -> Dict[str, torch.Tensor]:
        if self._data is None:
            items = [self.trainset[i] for i in range(len(self.trainset))]
            self._data = {k: torch.stack([_tensor(d[k], self.device)
                                          for d in items])
                          for k in ("camtoworld", "K", "image")}
        return self._data

    def isect_capacity(self) -> int:
        cap = self.splats["means"].shape[0]
        base = self.cfg.isect_capacity or max(cap * 4, 1 << 20)
        return base * self.isect_cap_scale

    def render_loss(self, params: Dict[str, torch.Tensor], c2w, Ks, target,
                    sh_degree: int, step: int):
        """The step's forward: render the views and score them against
        ``target`` [B, H, W, 3]. Returns (loss, meta, probe): ``probe`` is
        the tensor whose gradient the strategy reads (dL/d means2d, or with
        absgrad the per-Gaussian sums of |per-pixel dL/d means2d|)."""
        del step  # the 3DGS loss has no schedule
        cfg = self.cfg
        dev = self.device
        B, H, W = target.shape[:3]
        means, quats, scales, opac = splat_activations(params)
        colors = torch.cat([params["sh0"], params["shN"]], 1)
        bkgd = (torch.rand((B, 3), generator=self.generator, device=dev)
                if cfg.random_bkgd else None)
        cap = means.shape[0]
        probe = torch.zeros((B, cap, 2), device=dev, requires_grad=True)
        # the absgrad probe only under the fused backend (the JAX Runner's
        # use_absgrad); elsewhere the strategy reads dL/d means2d
        ag_probe = (torch.zeros((B, cap, 2), device=dev, requires_grad=True)
                    if getattr(self.strategy, "absgrad", False)
                    and cfg.rasterizer == "fused" else None)
        img, _, meta = rasterization(
            means, quats, scales, opac, colors, torch.linalg.inv(c2w), Ks,
            W, H, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            sh_degree=sh_degree, tile_size=cfg.tile_size, backgrounds=bkgd,
            rasterize_mode="antialiased" if cfg.antialiased else "classic",
            isect_capacity=self.isect_capacity(), rasterizer=cfg.rasterizer,
            cutoff_mode=cfg.cutoff_mode, grad_dtype=cfg.grad_dtype,
            log_composite=cfg.log_composite, attr_dtype=cfg.attr_dtype,
            means2d_probe=probe, absgrad_probe=ag_probe, device=dev)
        loss = combined_loss(img, target, cfg.ssim_lambda)
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * opac.abs().mean()
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * scales.abs().mean()
        return loss, meta, probe if ag_probe is None else ag_probe

    def _position_noise(self, shape) -> torch.Tensor:
        """MCMC's standard-normal draw for one step's position noise."""
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def train_step(self, idx: List[int], sh_degree: int,
                   step: int = 0) -> dict:
        """Step ``step`` (0-based) on the training views ``idx``. Returns
        the loss, the intersection count and whether the finite gate
        skipped the step; a skipped step leaves every parameter, moment and
        statistic as it was."""
        cfg = self.cfg
        dev = self.device
        data = self._device_trainset()
        sel = torch.as_tensor(idx, device=dev)
        c2w, Ks, target = (data[k][sel] for k in ("camtoworld", "K", "image"))
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.splats.items()}
        sim_params = {k: v.detach().requires_grad_(True)
                      for k, v in self.sim_params.items()}
        sim = self.compression_sim
        rparams = params
        if sim is not None:
            rparams, bits, aux = sim.simulate(params, sim_params, step,
                                              self.generator)
        loss, meta, probe = self.render_loss(rparams, c2w, Ks, target,
                                             sh_degree, step)
        if sim is not None:
            loss = loss + (cfg.rd_lambda * bits + aux)
        names, snames = list(params), list(sim_params)
        leaves = ([params[k] for k in names] + [sim_params[k] for k in snames]
                  + [probe])
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        param_grads = dict(zip(names, grads[:len(names)]))
        sim_grads = dict(zip(snames, grads[len(names):-1]))
        ok = torch.isfinite(loss)
        for g in grads[:-1]:
            ok = ok & torch.isfinite(g).all()
        # the step's one host sync: loss, gate, intersection count and the
        # simulation's bits and auxiliary loss
        extra = [] if sim is None else [bits, aux]
        stats = torch.cat([x.detach().double().reshape(1) for x in (
            loss, ok, meta["n_isects"], *extra)]).tolist()
        skipped = not stats[1]
        if skipped:
            self.skipped_steps += 1
        else:
            self.strategy_state = self.strategy.update_state(
                self.strategy_state, meta, grads[-1])
            self.splats, self.opt_states = apply_updates(
                self.groups, self.opt_states, self.splats, param_grads)
            if sim is not None:
                self.sim_params, self.sim_states = apply_updates(
                    self.sim_groups, self.sim_states, self.sim_params,
                    sim_grads)
            if isinstance(self.strategy, MCMCStrategy) and \
                    self.injects_noise:
                self.splats = self.strategy.inject_noise(
                    self.splats,
                    self._position_noise(self.splats["means"].shape),
                    self.groups["means"].lr_at(step))
        out = {"loss": stats[0], "n_isects": int(stats[2]),
               "skipped": skipped}
        if sim is not None:
            out["bits"], out["sim_aux"] = stats[3], stats[4]
        return out

    # -- loop ----------------------------------------------------------------

    def train(self, max_steps: Optional[int] = None,
              log_every: int = 100) -> List[float]:
        """Runs steps 0 .. max_steps - 1; returns the losses."""
        cfg = self.cfg
        max_steps = max_steps or cfg.max_steps
        strat = self.strategy
        B = cfg.batch_size
        order = self.view_order
        losses: List[float] = []
        t0 = time.time()
        for step0 in range(max_steps):
            sh_degree = min(step0 // cfg.sh_degree_interval, cfg.sh_degree)
            idx = [order[(step0 * B + j) % len(order)] for j in range(B)]
            out = self.train_step(idx, sh_degree, step0)
            step = step0 + 1
            if out["skipped"]:
                print(f"step {step}: step REJECTED (non-finite loss or "
                      f"gradients), state carried unchanged "
                      f"({self.skipped_steps} total)", flush=True)
            losses.append(out["loss"])
            if (strat.refine_start_iter < step < strat.refine_stop_iter
                    and step % strat.refine_every == 0):
                self._refine(step)
            if isinstance(strat, DefaultStrategy) and \
                    step % strat.reset_every == 0 and \
                    step < strat.refine_stop_iter:
                self.splats, self.opt_states = strat.maybe_reset_opacity(
                    self.splats, self.opt_states, step)
                self.events.append({"step": step, "event": "opacity_reset"})
            self._grow_capacity(step, out["n_isects"])
            for es in cfg.eval_steps:
                if es == step < max_steps:
                    m = self.eval(stage=f"val_step{es}")
                    print(f"step {step}: eval " + json.dumps(m), flush=True)
            if log_every and step % log_every == 0:
                print(f"step {step}: loss {out['loss']:.4f} isects "
                      f"{out['n_isects']} ({time.time() - t0:.1f}s)",
                      flush=True)
        return losses

    def _refine(self, step: int) -> None:
        new = self.strategy.refine(self.splats, self.opt_states,
                                   self.strategy_state, step,
                                   generator=self.generator)
        # the same finite gate as the step, on the refined parameters
        if all(bool(torch.isfinite(v).all()) for v in new[0].values()):
            self.splats, self.opt_states, self.strategy_state = new
            event = {"step": step, "event": "refine",
                     "live": num_live(self.splats)}
            if "allocated" in self.strategy_state:
                event["allocated"] = int(self.strategy_state["allocated"].sum())
            self.events.append(event)
        else:
            print(f"step {step}: refine REJECTED (non-finite parameters)",
                  flush=True)
            self.events.append({"step": step, "event": "refine_rejected"})

    def _grow_capacity(self, step: int, n_isects: int) -> None:
        """Double the intersection capacity at >= 95% fill, up to
        isect_cap_max_scale; beyond it the deepest intersections
        truncate."""
        cap = self.isect_capacity()
        if n_isects < 0.95 * cap:
            return
        if self.isect_cap_scale < self.cfg.isect_cap_max_scale:
            self.isect_cap_scale *= 2
            self.events.append({"step": step, "event": "isect_capacity",
                                "n_isects": n_isects,
                                "capacity": self.isect_capacity()})
            print(f"step {step}: ISECT OVERFLOW ({n_isects} >= 95% of "
                  f"{cap}), capacity doubles", flush=True)
        else:
            print(f"step {step}: isect buffer saturated ({n_isects} >= 95% "
                  f"of {cap}, growth bound reached), deepest intersections "
                  f"truncate", flush=True)

    # -- eval --------------------------------------------------------------

    def render_view(self, camtoworld, K, width: int, height: int,
                    sh_degree: Optional[int] = None) -> torch.Tensor:
        """[H, W, 3] render of the current splats, clipped to [0, 1]."""
        sh = self.cfg.sh_degree if sh_degree is None else sh_degree
        dev = self.device
        with torch.no_grad():
            means, quats, scales, opac = splat_activations(self.splats)
            colors = torch.cat([self.splats["sh0"], self.splats["shN"]], 1)
            viewmat = torch.linalg.inv(_tensor(camtoworld, dev))
            img, _, _ = rasterization(
                means, quats, scales, opac, colors, viewmat[None],
                _tensor(K, dev)[None], width, height, sh_degree=sh,
                isect_capacity=self.isect_capacity(),
                rasterizer=self.cfg.rasterizer,
                tile_size=self.cfg.tile_size, device=dev)
        return torch.clamp(img[0], 0.0, 1.0)

    def eval(self, stage: str = "val") -> Dict[str, float]:
        """Mean PSNR and SSIM over the validation views; also written to
        result_dir/stats/<stage>.json."""
        metrics = {"psnr": [], "ssim": []}
        for i in range(len(self.valset)):
            data = self.valset[i]
            tgt = _tensor(data["image"], self.device)
            h, w = tgt.shape[:2]
            img = self.render_view(data["camtoworld"], data["K"], w, h)
            with torch.no_grad():
                metrics["psnr"].append(float(psnr(img, tgt)))
                metrics["ssim"].append(float(ssim(img[None], tgt[None])))
        out = {k: float(np.mean(v)) for k, v in metrics.items()}
        stats_dir = os.path.join(self.cfg.result_dir, "stats")
        os.makedirs(stats_dir, exist_ok=True)
        with open(os.path.join(stats_dir, f"{stage}.json"), "w") as f:
            json.dump(out, f)
        return out
