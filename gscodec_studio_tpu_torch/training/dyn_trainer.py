"""Dynamic-splat trainer (port of gscodec_studio_tpu/training/dyn_trainer.py):
temporal Gaussians (models/temporal.py) trained on multiview video, on one
CUDA card unless ``device="cpu"``.

A step: the STG compression simulation (optional) -> the model sliced at
the sample's timestamp -> the colour head ("rgb": sigmoid(colors);
"linear": colour + direction and time features; "sandwich", the default:
the 9 raw feature channels, rendered, then the Sandwich decoder over the
feature map and per-pixel rays) -> ``rendering.rasterization`` with the
temporal opacity sigmoid(logit) * trbf, zero where trbf <= 0.05 -> L1 +
SSIM + rd_lambda * bits -> autograd -> the strategy's statistics (the
temporal-visibility gate under ModifiedSTG) and gradient mask (STG) ->
per-name Adam, the decoder's Adam and the sim parameters' Adam -> MCMC's
position noise. The steps run in chunks of at most ``steps_per_dispatch``
that end at every refine step, as the JAX package's scan dispatches do;
the chunk's losses are read once at its end. ``export_frames`` bakes
static per-frame splats for the sequence codec.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from gscodec_studio_tpu_torch.compression.png_io import write_png
from gscodec_studio_tpu_torch.compression_sim.simulation import (
    STGCompressionSimulation)
from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.models.splats import PARAM_LRS
from gscodec_studio_tpu_torch.models.temporal import (create_dyn_splats,
                                                      dyn_colors,
                                                      dyn_features,
                                                      extract_frame,
                                                      get_rays,
                                                      sandwich_apply,
                                                      sandwich_init,
                                                      slice_at_time)
from gscodec_studio_tpu_torch.optimizers.builders import (AdamGroup,
                                                          adam_state,
                                                          apply_updates)
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.strategy import (DefaultStrategy,
                                               MCMCStrategy,
                                               ModifiedSTGStrategy,
                                               STGStrategy)
from gscodec_studio_tpu_torch.training.losses import (combined_loss, psnr,
                                                      ssim)

DYN_PARAM_LRS = dict(
    PARAM_LRS,
    trbf_center=1e-3,
    trbf_scale=1e-3,
    motion=1.6e-4,  # scaled like the means
    omega=1e-3,
    features_dir=2.5e-3,
    features_time=2.5e-3,
)
EVAL_ISECT_CAPACITY = 1 << 19  # eval and render_view_video, as JAX's


@dataclass
class DynConfig:
    """The JAX package's DynConfig, field for field and default for
    default."""

    result_dir: str = "results/dyn"
    max_steps: int = 30_000
    capacity: Optional[int] = None
    isect_capacity: Optional[int] = None
    ssim_lambda: float = 0.2
    strategy: str = "mcmc"  # "mcmc" | "default" | "stg" | "modified_stg"
    # the refine window (None: the strategy's defaults)
    refine_start_iter: Optional[int] = None
    refine_stop_iter: Optional[int] = None
    refine_every: Optional[int] = None
    mcmc_cap_max: int = 200_000
    seed: int = 42
    steps_per_dispatch: int = 10
    near_plane: float = 0.01
    far_plane: float = 1e10
    temporal_visibility_mask: bool = True
    rasterizer: str = "fused"  # "fused" | "pallas" (v1) | "reference"
    color_mode: str = "sandwich"  # "rgb" | "linear" | "sandwich"
    decoder_lr: float = 1e-4
    # the STG compression simulation
    compression_sim: bool = False
    entropy_model_opt: bool = False
    rd_lambda: float = 1e-2


STRATEGIES = {"mcmc": MCMCStrategy, "default": DefaultStrategy,
              "stg": STGStrategy, "modified_stg": ModifiedSTGStrategy}


def check_dyn_config(cfg: DynConfig, rasterizers) -> None:
    """Raise ValueError for an unknown option."""
    for what, value, known in (("strategy", cfg.strategy, STRATEGIES),
                               ("color_mode", cfg.color_mode,
                                ("rgb", "linear", "sandwich")),
                               ("rasterizer", cfg.rasterizer, rasterizers)):
        if value not in known:
            raise ValueError(f"unknown {what} {value!r}")


class DynRunner:
    """Trains {means, quats, scales, opacities, trbf_center, trbf_scale,
    motion, omega, colors, features_dir, features_time} against samples
    {"camtoworld", "K", "image" [H, W, 3], "timestamp"}."""

    rasterizers = ("fused", "pallas", "reference")

    def __init__(self, cfg: DynConfig, points, rgbs, trainset, valset,
                 scene_scale: float = 1.0, device: DeviceLike = None):
        check_dyn_config(cfg, self.rasterizers)
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.trainset, self.valset = trainset, valset
        self.scene_scale = scene_scale
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)

        n_init = len(points)
        if cfg.strategy == "mcmc":
            cap = cfg.mcmc_cap_max
            strategy = MCMCStrategy(cap_max=cap)
        else:
            cap = cfg.capacity or 4 * n_init
            strategy = STRATEGIES[cfg.strategy]()
        cap = max(cap, n_init)
        overrides = {k: int(getattr(cfg, k)) for k in (
            "refine_start_iter", "refine_stop_iter", "refine_every")
            if getattr(cfg, k) is not None}
        self.strategy = dataclasses.replace(strategy, **overrides)
        self.splats = create_dyn_splats(points, rgbs, cap=cap, seed=cfg.seed,
                                        device=dev)
        self.groups, self.opt_states = {}, {}
        for name, p in self.splats.items():
            lr = DYN_PARAM_LRS.get(name, 1e-3)
            decay = None
            if name in ("means", "motion"):
                lr, decay = lr * scene_scale, cfg.max_steps
            self.groups[name] = AdamGroup(lr, 0.9, 0.999, 1e-15, decay)
            self.opt_states[name] = adam_state(p)
        if cfg.strategy == "mcmc":
            self.strategy_state = self.strategy.initialize_state(
                cap, scene_scale, n_init=n_init, device=dev)
        else:
            self.strategy_state = self.strategy.initialize_state(
                cap, scene_scale, device=dev)

        # the CNN colour decoder, apart from the per-splat tensors (the
        # strategies edit those row by row)
        self.decoder_params: Optional[Dict[str, torch.Tensor]] = None
        self.decoder_groups, self.decoder_states = {}, {}
        if cfg.color_mode == "sandwich":
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 3)
            self.decoder_params = sandwich_init(gen, dev)
            group = AdamGroup(cfg.decoder_lr, 0.9, 0.999, 1e-15)
            self.decoder_groups = {k: group for k in self.decoder_params}
            self.decoder_states = {k: adam_state(v) for k, v in
                                   self.decoder_params.items()}

        self.compression_sim = None
        self.sim_params: Dict[str, torch.Tensor] = {}
        self.sim_groups, self.sim_states = {}, {}
        if cfg.compression_sim:
            self.compression_sim = STGCompressionSimulation(
                entropy_model_opt=cfg.entropy_model_opt, cap=cap,
                max_steps=cfg.max_steps)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
            self.sim_params = self.compression_sim.init_params(gen, dev)
            self.sim_groups, self.sim_states = \
                self.compression_sim.build_optimizer(self.sim_params)
        # host-side sample order, the JAX runner's own numpy draw
        self.order = np.random.default_rng(cfg.seed).permutation(
            len(trainset)).tolist()
        self.events: List[dict] = []  # refines
        self.eval_isects: List[int] = []  # the last eval's, per view
        self._data = None
        os.makedirs(cfg.result_dir, exist_ok=True)

    # -- rendering ----------------------------------------------------------

    def isect_capacity(self) -> int:
        cap = self.splats["means"].shape[0]
        return self.cfg.isect_capacity or max(cap * 4, 1 << 19)

    def render_inputs(self, params, camtoworld, t):
        """What the renderer takes of ``params`` at time ``t`` seen from
        ``camtoworld``: (means, quats, linear scales, the temporal opacity
        sigmoid(logit) * trbf, zero where trbf <= 0.05 under
        temporal_visibility_mask, the colour head's colours or features,
        the trbf weight)."""
        cfg = self.cfg
        sliced, tw = slice_at_time(params, t)
        if cfg.color_mode == "sandwich":
            colors = dyn_features(params, t - params["trbf_center"])
        elif cfg.color_mode == "rgb":
            colors = torch.sigmoid(params["colors"])
        else:
            dirs = sliced["means"] - camtoworld[:3, 3][None, :]
            colors = torch.sigmoid(dyn_colors(params, dirs, tw))
        opac = torch.sigmoid(sliced["opacities"]) * tw
        if cfg.temporal_visibility_mask:
            opac = torch.where(tw > 0.05, opac, torch.zeros_like(opac))
        return (sliced["means"], sliced["quats"], torch.exp(sliced["scales"]),
                opac, colors, tw)

    def _render(self, params, camtoworld, K, t, width: int, height: int,
                isect_capacity: int, dec_params=None, probe=None):
        """(image [1, H, W, 3], alpha, meta with ``t_vis_mask``, trbf >
        0.05) of ``params`` at time ``t`` from one camera."""
        cfg = self.cfg
        means, quats, scales, opac, colors, tw = self.render_inputs(
            params, camtoworld, t)
        # inv_ex: a non-finite pose renders nothing instead of raising
        viewmat = torch.linalg.inv_ex(camtoworld)[0][None]
        img, alpha, meta = rasterization(
            means, quats, scales, opac, colors, viewmat, K[None], width,
            height,
            near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            sh_degree=None, isect_capacity=isect_capacity,
            rasterizer=cfg.rasterizer, means2d_probe=probe,
            device=self.device)
        meta = dict(meta, t_vis_mask=tw > 0.05)
        if cfg.color_mode == "sandwich":
            rays = get_rays(camtoworld, K, width, height)[None]
            img = sandwich_apply(dec_params, img, rays)
        return img, alpha, meta

    # -- one step -----------------------------------------------------------

    def _device_trainset(self) -> Dict[str, torch.Tensor]:
        """The train set on the device, once: camtoworld, K, image and
        timestamp of every sample."""
        if self._data is None:
            items = [self.trainset[i] for i in range(len(self.trainset))]
            self._data = {k: torch.as_tensor(
                np.stack([np.asarray(d[k], np.float32) for d in items]),
                device=self.device) for k in ("camtoworld", "K", "image",
                                              "timestamp")}
        return self._data

    def _position_noise(self, shape) -> torch.Tensor:
        """MCMC's standard-normal draw for one step's position noise."""
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def _split_samples(self, cap: int) -> torch.Tensor:
        """The default strategies' split draw for one refine."""
        return torch.randn((2, cap, 3), generator=self.generator,
                           device=self.device)

    def train_step(self, idx: int, step: int) -> torch.Tensor:
        """Step ``step`` (0-based) on train-set sample ``idx``; returns the
        loss (a device scalar, not synced)."""
        cfg, dev = self.cfg, self.device
        data = self._device_trainset()
        c2w, K, image, t = (data[k][idx] for k in ("camtoworld", "K",
                                                   "image", "timestamp"))
        H, W = image.shape[:2]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.splats.items()}
        dec = {k: v.detach().requires_grad_(True)
               for k, v in (self.decoder_params or {}).items()}
        simp = {k: v.detach().requires_grad_(True)
                for k, v in self.sim_params.items()}
        cap = params["means"].shape[0]
        probe = torch.zeros((1, cap, 2), device=dev, requires_grad=True)
        sim = self.compression_sim
        rparams = params
        if sim is not None:
            rparams, bits, _ = sim.simulate(params, simp, step,
                                            self.generator)
        img, _, meta = self._render(rparams, c2w, K, t, W, H,
                                    self.isect_capacity(), dec, probe)
        loss = combined_loss(img, image[None], cfg.ssim_lambda)
        if sim is not None:
            loss = loss + cfg.rd_lambda * bits
        trees = [params, dec, simp]
        names = [(i, k) for i, tree in enumerate(trees) for k in tree]
        leaves = [trees[i][k] for i, k in names] + [probe]
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [{}, {}, {}]
        for (i, k), g, x in zip(names, got, leaves):
            grads[i][k] = torch.zeros_like(x) if g is None else g
        v_means2d = got[-1] if got[-1] is not None else torch.zeros_like(
            probe)
        strat = self.strategy
        self.strategy_state = strat.update_state(self.strategy_state, meta,
                                                 v_means2d)
        pgrads = grads[0]
        if isinstance(strat, STGStrategy):
            pgrads = strat.mask_gradients(self.splats, pgrads, step,
                                          state=self.strategy_state)
        self.splats, self.opt_states = apply_updates(
            self.groups, self.opt_states, self.splats, pgrads)
        if dec:
            self.decoder_params, self.decoder_states = apply_updates(
                self.decoder_groups, self.decoder_states,
                self.decoder_params, grads[1])
        if sim is not None:
            self.sim_params, self.sim_states = apply_updates(
                self.sim_groups, self.sim_states, self.sim_params, grads[2])
        if isinstance(strat, MCMCStrategy):
            self.splats = strat.inject_noise(
                self.splats, self._position_noise(self.splats["means"].shape),
                self.groups["means"].lr_at(step))
        return loss.detach()

    # -- loop ----------------------------------------------------------------

    def train(self, max_steps: Optional[int] = None,
              log_every: int = 100) -> List[float]:
        """Runs steps 0 .. max_steps - 1 in chunks; returns the losses."""
        cfg = self.cfg
        max_steps = max_steps or cfg.max_steps
        strat = self.strategy
        order = self.order
        losses: List[float] = []
        t0 = time.time()
        step = 0
        while step < max_steps:
            S = min(cfg.steps_per_dispatch, max_steps - step,
                    strat.refine_every - (step % strat.refine_every))
            chunk = [self.train_step(order[(step + i) % len(order)],
                                     step + i) for i in range(S)]
            step += S
            losses.extend(torch.stack(chunk).tolist())
            if (strat.refine_start_iter < step < strat.refine_stop_iter
                    and step % strat.refine_every == 0):
                self._refine(step)
            if log_every and step % log_every < cfg.steps_per_dispatch:
                print(f"step {step}: loss {losses[-1]:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        return losses

    def _refine(self, step: int) -> None:
        strat = self.strategy
        kw = {"generator": self.generator}
        if not isinstance(strat, MCMCStrategy):
            kw["split_samples"] = self._split_samples(
                self.splats["means"].shape[0])
        self.splats, self.opt_states, self.strategy_state = strat.refine(
            self.splats, self.opt_states, self.strategy_state, step, **kw)
        event = {"step": step, "event": "refine", "live": int(
            (torch.sigmoid(self.splats["opacities"]) > 0.005).sum())}
        if "allocated" in self.strategy_state:
            event["allocated"] = int(self.strategy_state["allocated"].sum())
        self.events.append(event)

    # -- eval and export ----------------------------------------------------

    def render_frame(self, camtoworld, K, width: int, height: int, t):
        """([H, W, 3] render at time ``t``, clipped to [0, 1]; its
        intersection count, an int32 [1] tensor)."""
        dev = self.device
        with torch.no_grad():
            img, _, meta = self._render(
                self.splats, torch.as_tensor(np.asarray(camtoworld,
                                                        np.float32),
                                             device=dev),
                torch.as_tensor(np.asarray(K, np.float32), device=dev),
                torch.tensor(float(t), dtype=torch.float32, device=dev),
                width, height,
                self.cfg.isect_capacity or EVAL_ISECT_CAPACITY,
                self.decoder_params)
        return torch.clamp(img[0], 0.0, 1.0), meta["n_isects"]

    def eval(self) -> Dict[str, float]:
        """Mean PSNR and SSIM over the validation samples; each view's
        intersection count is left in ``eval_isects``."""
        out = {"psnr": [], "ssim": []}
        isects = []
        for i in range(len(self.valset)):
            d = self.valset[i]
            h, w = np.asarray(d["image"]).shape[:2]
            img, n_isects = self.render_frame(d["camtoworld"], d["K"], w, h,
                                              d["timestamp"])
            tgt = torch.as_tensor(np.asarray(d["image"], np.float32),
                                  device=self.device)
            with torch.no_grad():
                out["psnr"].append(float(psnr(img, tgt)))
                out["ssim"].append(float(ssim(img[None], tgt[None])))
            isects.append(int(n_isects))
        self.eval_isects = isects
        return {k: float(np.mean(v)) for k, v in out.items()}

    def render_view_video(self, camtoworld, K, width: int, height: int,
                          timestamps, out_path: str, fps: int = 30) -> str:
        """The model rendered from one camera at each timestamp: an mp4 at
        ``out_path`` where imageio writes one, else a folder of PNG frames
        beside it (its name without the extension). Returns the path."""
        frames = [(np.clip(self.render_frame(camtoworld, K, width, height,
                                             t)[0].cpu().numpy(), 0, 1)
                   * 255).astype(np.uint8) for t in timestamps]
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(out_path, frames, fps=fps)
        except Exception:  # no imageio, or no mp4 writer: PNG frames
            out_path = os.path.splitext(out_path)[0]
            os.makedirs(out_path, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(out_path, f"{i:04d}.png"), f)
        return out_path

    def export_frames(self, timestamps) -> List[Dict[str, np.ndarray]]:
        """Static per-frame splats (models.temporal.extract_frame) for the
        sequence codec."""
        return [extract_frame(self.splats, float(t)) for t in timestamps]
