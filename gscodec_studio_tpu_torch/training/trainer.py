"""Static 3DGS trainer (port of gscodec_studio_tpu/training/trainer.py):
``Config`` with every field of the JAX package's, and a ``Runner`` that
trains on one CUDA card with the default or the MCMC strategy, optionally
under the compression simulation (the garden ladder's recipe) and with the
per-image modules: pose deltas, appearance, the bilateral grid and the
SfM depth loss. Given no parser it loads ``cfg.data_dir``, a COLMAP scene
(datasets/colmap.py); ``simple_trainer.py`` is its command line.

A step: the compression simulation (fake quantization, entropy bits, the
shN mask) -> the pose deltas on the batch's c2w -> activations (with
appearance, per-camera colours from its MLP) -> ``rendering.rasterization``
(projection, SH, binning and the rasterizer's forward and backward
kernels: the fused backend, its gradient rows in f32 or packed bf16 pairs,
or by ``cfg.rasterizer`` the legacy v1 kernels or the dense oracle; with
the depth loss RGB+ED) -> the bilateral grid -> L1 + SSIM loss, the
disparity L1 at the SfM tracks, the grid's TV, the regularisers and
rd_lambda * bits (all in ``Runner.render_loss``, which the 2DGS runner
overrides, but the bits) -> autograd -> the densification statistics from
the means2d probe's gradient -> per-group Adam (SelectiveAdam over the
rows the batch's cameras saw, with ``visible_adam``), the sim parameters'
Adam, the per-image modules' AdamW/Adam, and with MCMC the position noise.
A finite-step gate skips a step whose loss or any gradient is not finite,
counts it, writes which leaves were not finite to ``skips.jsonl`` and
replays it once (``skip_probe``). Between steps the loop runs the
strategy's refine (and the default strategy's opacity reset), the
SH-degree schedule, the adaptive intersection capacity, the scalars and
histograms (``utils/logger.py``, result_dir/tb), and at ``eval_steps`` and
``save_steps`` the evaluation and the checkpoint. After training,
``save_checkpoint``/``load_checkpoint`` (npz files both packages read),
``save_ply``, ``render_traj`` and ``run_compression`` ("png" or
"entropy_coding") store, show and compress the scene.

Mesh mode (``mesh_devices`` = G > 1): one process a rank, in a process
group of G ranks (parallel/launcher.py), each running this Runner on one
contiguous shard of the Gaussians and B/G of the batch's cameras through
parallel.distributed.sharded_rasterization (the dense exchange, or the
capacity-bounded one with ``exchange_cap``). The step's loss is the mean
over the ranks and each rank's gradients are those of that mean; the
simulation's and the per-image modules' gradients (replicated parameters)
are summed over the ranks, the finite gate and the diagnostics are the
worst over the ranks, and each rank's Adam updates its own shard. A refine
gathers the per-Gaussian state on every rank, runs with a generator all
ranks share and keeps the rank's slice; evaluation, rendering, checkpoints,
the PLY and the codecs run on the gathered splats, and rank 0 alone writes
files. The sim dither, the random backgrounds and MCMC's position noise
draw from a generator seeded per rank.

The port loops in Python, one step per iteration; the JAX package's
``lax.scan`` chunks (``steps_per_dispatch``) were a TPU dispatch device.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from gscodec_studio_tpu_torch.compression import (EntropyCodingCompression,
                                                 PngCompression,
                                                 compressed_size)
from gscodec_studio_tpu_torch.compression.png_io import write_png
from gscodec_studio_tpu_torch.compression_sim import CompressionSimulation
from gscodec_studio_tpu_torch.compression_sim.hash_grid import (
    gaussian_conditional_cfgs)
from gscodec_studio_tpu_torch.compression_sim.simulation import (
    entropy_model_params)
from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.models.splats import (DEAD_OPACITY_LOGIT,
                                                    create_splats,
                                                    jax_leaf_order, num_live,
                                                    splat_activations)
from gscodec_studio_tpu_torch.optimizers import (apply_updates,
                                                 build_splat_optimizers)
from gscodec_studio_tpu_torch.optimizers.builders import AdamGroup, adam_state
from gscodec_studio_tpu_torch.parallel.distributed import (
    Mesh, make_mesh, shard_rows, sharded_rasterization)
from gscodec_studio_tpu_torch.rendering import rasterization
from gscodec_studio_tpu_torch.strategy import DefaultStrategy, MCMCStrategy
from gscodec_studio_tpu_torch.training.losses import (combined_loss, psnr,
                                                      ssim)
from gscodec_studio_tpu_torch.training.lpips import (load_lpips_weights,
                                                     lpips, lpips_available)
from gscodec_studio_tpu_torch.utils.bilagrid import (bilagrid_init,
                                                     bilagrid_slice,
                                                     bilagrid_tv_loss,
                                                     jnp_clip)
from gscodec_studio_tpu_torch.utils.camera_opt import (AppearanceOptModule,
                                                       appearance_opt_apply,
                                                       camera_opt_apply,
                                                       camera_opt_init)
from gscodec_studio_tpu_torch.utils.logger import TrainLogger
from gscodec_studio_tpu_torch.utils.ply import save_ply


@dataclass
class Config:
    """The JAX package's Config, field for field and default for default."""

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

    # Camera pose, appearance, bilateral grid, SfM depth loss
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

    # Observability: scalars and histograms (result_dir/tb), render dumps
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

    # Gaussian-sharded training over a process group of mesh_devices ranks
    # (0 or 1: one device); exchange_cap bounds each destination's rows
    mesh_devices: int = 0
    exchange_cap: Optional[int] = None

    # Compression simulation ("factorized_model" or "gaussian_model")
    compression_sim: bool = False
    rd_lambda: float = 0.01
    entropy_model_opt: bool = False
    entropy_model_type: str = "factorized_model"
    shN_ada_mask_opt: bool = False


def check_config(cfg: Config, rasterizers=("fused",)) -> None:
    """Raise for a value the runner does not take."""
    if cfg.rasterizer not in rasterizers:
        raise ValueError(f"unknown rasterizer {cfg.rasterizer!r}")
    if cfg.strategy not in ("default", "mcmc"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.grad_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r}")
    if cfg.attr_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown attr_dtype {cfg.attr_dtype!r}")


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor)
                           else np.asarray(x, np.float32),
                           dtype=torch.float32, device=dev)


def _sample_bilinear(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples [B, M] of ``img`` [B, H, W, 1] at pixel coordinates
    ``pts`` [B, M, 2] (x, y): grid_sample(align_corners=True) after
    x / (W - 1) * 2 - 1, the corners clipped into the image."""
    B, H, W, _ = img.shape
    im = img[..., 0]
    x = jnp_clip(pts[..., 0], 0.0, W - 1.0)
    y = jnp_clip(pts[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 2)
    fx = x - x0
    fy = y - y0
    flat = im.reshape(B, H * W)  # gathers whose backward scatters
    at = y0 * W + x0
    v00 = flat.gather(1, at)
    v01 = flat.gather(1, at + 1)
    v10 = flat.gather(1, at + W)
    v11 = flat.gather(1, at + W + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _depth_l1(depth_map: torch.Tensor, points: torch.Tensor,
              depths: torch.Tensor) -> torch.Tensor:
    """The disparity L1 between the rendered depth ``depth_map``
    [B, H, W, 1], sampled at the tracks' pixels ``points`` [B, M, 2], and
    the tracks' ``depths`` [B, M], over the tracks with a depth (> 0). The
    double where keeps the masked branch's gradient finite where the
    rendered depth is 0."""
    d_at = _sample_bilinear(depth_map, points)
    valid = depths > 0.0
    pos = d_at > 0.0
    disp = torch.where(pos, 1.0 / torch.where(pos, d_at, 1.0), 0.0)
    disp_gt = torch.where(valid, 1.0 / torch.clamp(depths, min=1e-8), 0.0)
    return (torch.abs(disp - disp_gt) * valid).sum() / torch.clamp(
        valid.sum(), min=1.0)


def keystr(tree_index: int, name: str) -> str:
    """jax.tree_util.keystr of a leaf of the JAX Runner's (splats,
    sim_params, aux_params) tuple, from its tree's index and its flat
    dotted name: (0, "means") -> "[0]['means']", (2, "app_mlp.0.w") ->
    "[2]['app_mlp'][0]['w']"."""
    return f"[{tree_index}]" + "".join(
        f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))


PROBE_VERDICTS = ("REPRODUCED (deterministic bug candidate)",
                  "clean on replay (transient signature)")


class _NoLogger:
    """The logger of a rank that writes no files."""

    def scalars(self, values, step):
        pass

    def histogram(self, tag, values, step, bins=64):
        pass


class Runner:
    """Trains a 3DGS scene. ``parser`` gives ``points`` [N, 3],
    ``points_rgb`` [N, 3] in 0..255 and ``scene_scale``; the datasets give
    dicts with "camtoworld", "K" and "image" [H, W, 3] in [0, 1] (and with
    the depth loss "points" [M, 2] and "depths" [M]). Given no parser it
    loads ``cfg.data_dir`` with datasets.colmap."""

    # the cfg.rasterizer values this runner takes
    rasterizers = ("fused", "pallas", "reference")
    injects_noise = True  # MCMC's per-step position noise
    has_mesh_mode = True  # Gaussian-sharded over mesh_devices ranks

    def __init__(self, cfg: Config, parser=None, trainset=None, valset=None,
                 device: DeviceLike = None):
        check_config(cfg, self.rasterizers)
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.mesh: Optional[Mesh] = self._make_mesh(cfg, dev)
        if parser is None:
            from gscodec_studio_tpu_torch.datasets.colmap import (Dataset,
                                                                  Parser)

            parser = Parser(cfg.data_dir, factor=cfg.data_factor,
                            test_every=cfg.test_every,
                            load_points2d=cfg.depth_loss)
            trainset = Dataset(parser, split="train",
                               load_depths=cfg.depth_loss)
            valset = Dataset(parser, split="val")
        self.parser, self.trainset, self.valset = parser, trainset, valset
        self.scene_scale = float(getattr(parser, "scene_scale", 1.0))
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)

        points = np.asarray(parser.points, np.float32)
        rgbs = np.asarray(parser.points_rgb) / 255.0
        if cfg.init_type == "random":
            # the JAX Runner's draws, so that both packages start from the
            # same points
            rng = np.random.default_rng(cfg.seed)
            points = ((rng.random((cfg.init_num_pts, 3)) * 2 - 1) * 3.0
                      * self.scene_scale).astype(np.float32)
            rgbs = rng.random((cfg.init_num_pts, 3)).astype(np.float32)
        n_init = points.shape[0]
        if cfg.strategy == "mcmc":
            cap = cfg.mcmc_cap_max
            strategy = MCMCStrategy(cap_max=cap)
        else:
            cap = cfg.capacity or 4 * n_init
            strategy = DefaultStrategy()
        cap = max(cap, n_init)
        if self.mesh is not None:
            G = self.mesh.size
            cap = -(-cap // G) * G  # the shards must be equal
        overrides = {k: int(getattr(cfg, k)) for k in (
            "refine_start_iter", "refine_stop_iter", "refine_every")
            if getattr(cfg, k) is not None}
        self.strategy = replace(strategy, **overrides)
        # under the mesh every rank makes the whole model from the same
        # draws and keeps its rows
        self.splats = self._shard(create_splats(
            points, rgbs, cap=cap, sh_degree=cfg.sh_degree,
            init_opacity=cfg.init_opa, init_scale=cfg.init_scale,
            feature_dim=cfg.app_feature_dim if cfg.app_opt else None,
            generator=self.generator, device=dev), cap)
        self.groups, self.opt_states = build_splat_optimizers(
            self.splats, scene_scale=self.scene_scale,
            batch_size=cfg.batch_size, max_steps=cfg.max_steps,
            visible_adam=cfg.visible_adam)
        if cfg.strategy == "mcmc":
            self.strategy_state = self.strategy.initialize_state(
                cap, self.scene_scale, n_init=n_init, device=dev)
        else:
            self.strategy_state = self.strategy.initialize_state(
                cap, self.scene_scale, device=dev)
        self.strategy_state = self._shard(self.strategy_state)
        # refines draw from the generator that made the splats, which
        # under the mesh goes on alike on every rank; the step's draws
        # come from one seeded per rank
        self._shared_generator = self.generator
        if self.mesh is not None:
            self.generator = torch.Generator(device=dev).manual_seed(
                cfg.seed + 1_000_003 * (self.mesh.rank + 1))
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
        self._init_aux(n_train)
        # host-side ordering, the JAX Runner's own draw (not a device draw)
        self.view_order = np.random.default_rng(cfg.seed).permutation(
            n_train).tolist()
        self.skipped_steps = 0
        self.isect_cap_scale = 1
        self.events: List[dict] = []  # refines, resets, capacity changes
        self._data = None
        os.makedirs(cfg.result_dir, exist_ok=True)
        self.logger = TrainLogger(os.path.join(cfg.result_dir, "tb")) \
            if self.writes else _NoLogger()
        self._name_ignored()

    # -- the mesh ------------------------------------------------------------

    def _make_mesh(self, cfg: Config, dev: torch.device) -> Optional[Mesh]:
        """The mesh of cfg.mesh_devices ranks, or None for one device. The
        batch must split over the ranks, and this process must belong to a
        process group of exactly that many ranks."""
        G = cfg.mesh_devices
        if not G or G <= 1:
            return None
        if not self.has_mesh_mode:
            raise ValueError(f"{type(self).__name__} has no mesh mode (the "
                             f"JAX package's has none either)")
        if cfg.batch_size % G:
            raise ValueError("batch_size must be divisible by mesh_devices")
        if cfg.rasterizer != "fused":
            raise ValueError(f"mesh_devices={G} renders through the fused "
                             f"backend only, not {cfg.rasterizer!r}")
        return make_mesh(G, device=dev)

    @property
    def writes(self) -> bool:
        """Whether this process writes files: rank 0 under the mesh."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def refine_generator(self) -> torch.Generator:
        """The refine's draws: under the mesh a generator that every rank
        holds in the same state."""
        return self._shared_generator if self.mesh is not None \
            else self.generator

    def _per_gaussian(self, x, n: int) -> bool:
        return isinstance(x, torch.Tensor) and x.ndim >= 1 and \
            x.shape[0] == n

    def _shard(self, tree: Dict, cap: Optional[int] = None) -> Dict:
        """This rank's rows of the per-Gaussian tensors of ``tree`` (those
        of the whole capacity ``cap``, by default the runner's; nested
        dicts too); the tree itself without the mesh."""
        if self.mesh is None:
            return tree
        cap = self.cap if cap is None else cap
        return {k: self._shard(v, cap) if isinstance(v, dict) else
                shard_rows(self.mesh, v) if self._per_gaussian(v, cap) else v
                for k, v in tree.items()}

    def _gather(self, tree: Dict) -> Dict:
        """The whole model's per-Gaussian tensors of ``tree`` (the ranks'
        rows in rank order); the tree itself without the mesh."""
        if self.mesh is None:
            return tree
        n = self.splats["means"].shape[0]
        return {k: self._gather(v) if isinstance(v, dict) else
                self.mesh.all_gather(v) if self._per_gaussian(v, n) else v
                for k, v in tree.items()}

    @property
    def cap(self) -> int:
        """The whole model's slot count."""
        n = self.splats["means"].shape[0]
        return n * self.mesh.size if self.mesh is not None else n

    def _sum_over_ranks(self, grads: Dict[str, torch.Tensor]) -> Dict:
        """The replicated parameters' gradients summed over the ranks, in
        one collective."""
        if self.mesh is None or not grads:
            return grads
        names = list(grads)
        flat = self.mesh.all_reduce(torch.cat([grads[k].reshape(-1)
                                               for k in names]))
        out, lo = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[lo:lo + n].reshape(grads[k].shape)
            lo += n
        return out

    def _init_aux(self, n_train: int) -> None:
        """The per-image modules' parameters (``aux_params``, flat names:
        pose, app_embeds, app_mlp.<i>.w/b, bilagrid) and their optimizers:
        optax.adamw(lr * sqrt(B), weight_decay, eps=1e-15) for the pose and
        the appearance (its embeddings at 10x the MLP's rate) and
        optax.adam(2e-3, eps=1e-15) for the grids, as the JAX Runner
        builds them. The appearance MLP's head starts at zero, so that
        appearance starts as the identity."""
        cfg, dev = self.cfg, self.device
        bs_scale = math.sqrt(cfg.batch_size)
        aux: Dict[str, torch.Tensor] = {}
        groups: Dict[str, AdamGroup] = {}

        def adamw(lr, wd):
            return AdamGroup(lr, 0.9, 0.999, 1e-15, weight_decay=wd)

        if cfg.pose_opt:
            aux["pose"] = camera_opt_init(n_train, device=dev)
            groups["pose"] = adamw(cfg.pose_opt_lr * bs_scale,
                                   cfg.pose_opt_reg)
        if cfg.app_opt:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
            app = AppearanceOptModule(
                n_train, feature_dim=cfg.app_feature_dim,
                embed_dim=cfg.app_embed_dim, sh_degree=cfg.sh_degree,
                generator=gen, device=dev)
            layers = app.layers()
            aux["app_embeds"] = app.embeds.detach()
            groups["app_embeds"] = adamw(cfg.app_opt_lr * bs_scale * 10.0,
                                         cfg.app_opt_reg)
            for i, layer in enumerate(layers):
                for k, v in layer.items():
                    head = i == len(layers) - 1
                    name = f"app_mlp.{i}.{k}"
                    aux[name] = torch.zeros_like(v) if head else v.detach()
                    groups[name] = adamw(cfg.app_opt_lr * bs_scale,
                                         cfg.app_opt_reg)
        if cfg.use_bilateral_grid:
            D, Hg, Wg = cfg.bilagrid_shape
            aux["bilagrid"] = bilagrid_init(n_train, D, Hg, Wg, device=dev)
            groups["bilagrid"] = AdamGroup(2e-3, 0.9, 0.999, 1e-15)
        self.aux_params = aux
        self.aux_groups = groups
        self.aux_states = {k: adam_state(v) for k, v in aux.items()}

    def app_mlp(self, aux: Dict[str, torch.Tensor]) -> List[dict]:
        """The appearance MLP's layers, [{"w", "b"}], of flat ``aux``."""
        n = len([k for k in aux if k.startswith("app_mlp.")]) // 2
        return [{"w": aux[f"app_mlp.{i}.w"], "b": aux[f"app_mlp.{i}.b"]}
                for i in range(n)]

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
        """The train set on the device, once: camtoworld, K and image, and
        with the depth loss each view's tracks padded to depth_points_cap
        (points [n, cap, 2]; depths [n, cap], zero past a view's tracks,
        which the loss masks out)."""
        if self._data is None:
            items = [self.trainset[i] for i in range(len(self.trainset))]
            self._data = {k: torch.stack([_tensor(d[k], self.device)
                                          for d in items])
                          for k in ("camtoworld", "K", "image")}
            if self.cfg.depth_loss:
                capd = self.cfg.depth_points_cap
                pts = np.zeros((len(items), capd, 2), np.float32)
                dps = np.zeros((len(items), capd), np.float32)
                for i, d in enumerate(items):
                    m = min(len(d.get("depths", ())), capd)
                    if m:
                        pts[i, :m] = d["points"][:m]
                        dps[i, :m] = d["depths"][:m]
                self._data["points"] = _tensor(pts, self.device)
                self._data["depths"] = _tensor(dps, self.device)
        return self._data

    def isect_capacity(self) -> int:
        base = self.cfg.isect_capacity or max(self.cap * 4, 1 << 20)
        return base * self.isect_cap_scale

    def render_loss(self, params: Dict[str, torch.Tensor], c2w, Ks, target,
                    sh_degree: int, step: int,
                    aux: Optional[Dict[str, torch.Tensor]] = None,
                    view: Optional[Dict[str, torch.Tensor]] = None):
        """The step's forward: render the views and score them against
        ``target`` [B, H, W, 3]. ``aux`` are the per-image modules'
        parameters, ``view`` holds the views' train-set positions ("idx")
        and, with the depth loss, their tracks ("points", "depths").
        Returns (loss, meta, probe): ``probe`` is the tensor whose gradient
        the strategy reads (dL/d means2d, or with absgrad the per-Gaussian
        sums of |per-pixel dL/d means2d|)."""
        del step  # the 3DGS loss has no schedule
        cfg = self.cfg
        dev = self.device
        aux = aux or {}
        idx = None if view is None else view["idx"]
        B, H, W = target.shape[:3]
        if cfg.pose_opt:
            c2w = camera_opt_apply(aux["pose"], c2w, idx)
        means, quats, scales, opac = splat_activations(params)
        if cfg.app_opt:
            dirs = means[None, :, :] - c2w[:, None, :3, 3]
            colors = torch.sigmoid(appearance_opt_apply(
                aux["app_embeds"], self.app_mlp(aux), params["features"],
                idx, dirs, sh_degree, sh_degree_max=cfg.sh_degree)
                + params["colors"][None])  # [B, N, 3]
            sh_for_raster = None
        else:
            colors = torch.cat([params["sh0"], params["shN"]], 1)
            sh_for_raster = sh_degree
        bkgd = (torch.rand((B, 3), generator=self.generator, device=dev)
                if cfg.random_bkgd else None)
        cap = means.shape[0]
        probe = torch.zeros((B, cap, 2), device=dev, requires_grad=True)
        # the absgrad probe only under the fused backend (the JAX Runner's
        # use_absgrad); elsewhere the strategy reads dL/d means2d
        ag_probe = (torch.zeros((B, cap, 2), device=dev, requires_grad=True)
                    if getattr(self.strategy, "absgrad", False)
                    and cfg.rasterizer == "fused" else None)
        # inv_ex: a non-finite pose gives a non-finite view for the finite
        # gate to skip, where linalg.inv raises on the card (as jnp's
        # inverse does not)
        viewmats = torch.linalg.inv_ex(c2w)[0]
        render_mode = "RGB+ED" if cfg.depth_loss else "RGB"
        if self.mesh is not None:
            # the rank renders and scores its B/G cameras
            img, _, meta = sharded_rasterization(
                self.mesh, means, quats, scales, opac, colors, viewmats, Ks,
                W, H, sh_for_raster, self.isect_capacity(),
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                tile_size=cfg.tile_size, backgrounds=bkgd,
                means2d_probe=probe, absgrad_probe=ag_probe,
                exchange_cap=cfg.exchange_cap, antialiased=cfg.antialiased,
                cutoff_mode=cfg.cutoff_mode, grad_dtype=cfg.grad_dtype,
                attr_dtype=cfg.attr_dtype, log_composite=cfg.log_composite,
                render_mode=render_mode)
            target = shard_rows(self.mesh, target)
            if view is not None:
                view = {k: shard_rows(self.mesh, v) for k, v in view.items()}
                idx = view["idx"]
        else:
            img, _, meta = rasterization(
                means, quats, scales, opac, colors, viewmats, Ks, W, H,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                sh_degree=sh_for_raster, tile_size=cfg.tile_size,
                backgrounds=bkgd, render_mode=render_mode,
                rasterize_mode="antialiased" if cfg.antialiased
                else "classic",
                isect_capacity=self.isect_capacity(),
                rasterizer=cfg.rasterizer, cutoff_mode=cfg.cutoff_mode,
                grad_dtype=cfg.grad_dtype, log_composite=cfg.log_composite,
                attr_dtype=cfg.attr_dtype, means2d_probe=probe,
                absgrad_probe=ag_probe, device=dev)
        if cfg.depth_loss:
            img, depth_map = img[..., :3], img[..., 3:4]
        if cfg.use_bilateral_grid:
            img = bilagrid_slice(aux["bilagrid"], idx, img)
        loss = combined_loss(img, target, cfg.ssim_lambda)
        if cfg.depth_loss:
            l1 = _depth_l1(depth_map, view["points"], view["depths"])
            loss = loss + cfg.depth_lambda * l1 * self.scene_scale
        if cfg.use_bilateral_grid:
            loss = loss + 10.0 * bilagrid_tv_loss(aux["bilagrid"])
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * opac.abs().mean()
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * scales.abs().mean()
        return loss, meta, probe if ag_probe is None else ag_probe

    def _visibility(self, meta) -> torch.Tensor:
        """SelectiveAdam's rows: those that a camera of the batch gave a
        radius ([cap] bool)."""
        return (meta["radii"] > 0).sum(0) > 0

    def _position_noise(self, shape) -> torch.Tensor:
        """MCMC's standard-normal draw for one step's position noise."""
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def leaf_names(self) -> List[str]:
        """The finite gate's leaves as the JAX Runner names them: "loss",
        then jax.tree_util.keystr of each leaf of (splats, sim_params,
        aux_params) in its flatten order."""
        return ["loss"] + [keystr(t, k) for t, tree in enumerate(
            (self.splats, self.sim_params, self.aux_params))
            for k in jax_leaf_order(tree)]

    def _forward_backward(self, idx: List[int], sh_degree: int, step: int):
        """Loss and gradients of the step on the training views ``idx``:
        (loss, meta, {tree: {name: gradient}}, probe gradient, [the
        gradient leaves' finite flags in leaf_names' order after the
        loss], the simulation's (bits, aux) or ())."""
        cfg = self.cfg
        dev = self.device
        data = self._device_trainset()
        sel = torch.as_tensor(idx, device=dev)
        c2w, Ks, target = (data[k][sel] for k in ("camtoworld", "K", "image"))
        view = {"idx": sel}
        if cfg.depth_loss:
            view.update(points=data["points"][sel], depths=data["depths"][sel])
        trees = [{k: v.detach().requires_grad_(True) for k, v in t.items()}
                 for t in (self.splats, self.sim_params, self.aux_params)]
        params, sim_params, aux = trees
        sim = self.compression_sim
        rparams = params
        if sim is not None:
            sp = sim_params
            if self.mesh is not None and "ada_mask" in sp:
                # the shN mask has a slot a Gaussian: the rank's rows
                sp = dict(sp, ada_mask=shard_rows(self.mesh, sp["ada_mask"]))
            rparams, bits, sim_aux = sim.simulate(params, sp, step,
                                                  self.generator)
        loss, meta, probe = self.render_loss(rparams, c2w, Ks, target,
                                             sh_degree, step, aux=aux,
                                             view=view)
        if sim is not None:
            loss = loss + (cfg.rd_lambda * bits + sim_aux)
        names = [(t, k) for t, tree in enumerate(trees)
                 for k in jax_leaf_order(tree)]
        leaves = [trees[t][k] for t, k in names] + [probe]
        # under the mesh the step's loss is the mean of the ranks' losses:
        # each rank differentiates its share, and the exchange's backward
        # brings every rank's share to the Gaussians' own rank
        share = loss / self.mesh.size if self.mesh is not None else loss
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(share, leaves, allow_unused=True))]
        out = [{}, {}, {}]
        for (t, k), g in zip(names, grads):
            out[t][k] = g
        out[1] = self._sum_over_ranks(out[1])
        out[2] = self._sum_over_ranks(out[2])
        grads = [out[t][k] for t, k in names] + grads[-1:]
        leaf_ok = [torch.isfinite(g).all() for g in grads[:-1]]
        return (loss, meta, out, grads[-1], leaf_ok,
                () if sim is None else (bits, sim_aux))

    def train_step(self, idx: List[int], sh_degree: int,
                   step: int = 0) -> dict:
        """Step ``step`` (0-based) on the training views ``idx`` (train-set
        positions). Returns the loss, the intersection count and whether
        the finite gate skipped the step; a skipped step leaves every
        parameter, moment and statistic as it was, and with ``skip_probe``
        is replayed once from the generator's state before it
        (``out["probe"]``)."""
        cfg = self.cfg
        sim = self.compression_sim
        # the skip probe stays off under the mesh, as in the JAX package
        probe = cfg.skip_probe and self.mesh is None
        pre = self.generator.get_state() if probe else None
        loss, meta, grads, probe_grad, leaf_ok, extra = \
            self._forward_backward(idx, sh_degree, step)
        # the step's one host sync: loss, intersection count, the
        # simulation's bits and auxiliary loss and the leaves' flags
        stats = torch.cat([x.detach().double().reshape(1) for x in (
            loss, meta["n_isects"], *extra, *leaf_ok)])
        exchange = None
        if self.mesh is not None:
            stats, exchange = self._reduce_stats(stats, meta, len(extra))
        stats = stats.tolist()
        flags = stats[2 + len(extra):]
        finite = [math.isfinite(stats[0])] + [bool(f) for f in flags]
        skipped = not all(finite)
        param_grads, sim_grads, aux_grads = grads
        if skipped:
            self.skipped_steps += 1
        else:
            self.strategy_state = self.strategy.update_state(
                self.strategy_state, meta, probe_grad)
            visibility = self._visibility(meta) if cfg.visible_adam \
                else None
            self.splats, self.opt_states = apply_updates(
                self.groups, self.opt_states, self.splats, param_grads,
                visibility=visibility, visible_adam=cfg.visible_adam)
            if sim is not None:
                self.sim_params, self.sim_states = apply_updates(
                    self.sim_groups, self.sim_states, self.sim_params,
                    sim_grads)
            if self.aux_params:
                self.aux_params, self.aux_states = apply_updates(
                    self.aux_groups, self.aux_states, self.aux_params,
                    aux_grads)
            if isinstance(self.strategy, MCMCStrategy) and \
                    self.injects_noise:
                self.splats = self.strategy.inject_noise(
                    self.splats,
                    self._position_noise(self.splats["means"].shape),
                    self.groups["means"].lr_at(step))
        out = {"loss": stats[0], "n_isects": int(stats[1]),
               "skipped": skipped}
        if sim is not None:
            out["bits"], out["sim_aux"] = stats[2], stats[3]
        if exchange is not None:
            out["exchange"] = exchange
        if skipped:
            out["bad_leaves"] = [n for n, ok in zip(self.leaf_names(), finite)
                                 if not ok]
            if probe:
                out["probe"] = self._probe(idx, sh_degree, step, pre)
        return out

    def _reduce_stats(self, stats: torch.Tensor, meta, n_extra: int):
        """The step's statistics over the ranks: the loss and the
        simulation's terms their mean, the intersection count (already
        the largest over the ranks) and the finite flags their worst, and
        the exchange's diagnostics their largest ({overflow, sent_rows,
        dense_rows, bytes})."""
        mesh = self.mesh
        n_mean = 1 + n_extra
        means = torch.cat([stats[:1], stats[2:2 + n_mean - 1]])
        means = mesh.all_reduce(means) / mesh.size
        keys = ("overflow", "sent_rows", "dense_rows", "bytes")
        worst = torch.cat([
            stats[1:2], torch.stack([meta["exchange_" + k].double()
                                     for k in keys]),
            -stats[1 + n_mean:]])
        worst = mesh.all_reduce(worst, "max")
        out = torch.cat([means[:1], worst[:1], means[1:],
                         -worst[1 + len(keys):]])
        return out, {k: int(v) for k, v in zip(keys, worst[1:1 + len(keys)]
                                               .tolist())}

    def _probe(self, idx, sh_degree: int, step: int, pre) -> str:
        """The one-retry probe of a skipped step: the same views, step and
        generator state (``pre``, taken before the step) on the state the
        step left, which a skipped step leaves as it was before it. Unlike
        the JAX Runner, which replays on the state after its chunk, this
        replays the pre-step state. The generator goes on from where the
        step left it."""
        post = self.generator.get_state()
        self.generator.set_state(pre)
        try:
            loss, _, _, _, leaf_ok, _ = self._forward_backward(
                idx, sh_degree, step)
            clean = bool(torch.isfinite(loss)) and all(
                bool(f) for f in leaf_ok)
            return PROBE_VERDICTS[1] if clean else PROBE_VERDICTS[0]
        except Exception as e:  # the probe is a diagnostic, never fatal
            return f"probe failed: {e!r}"
        finally:
            self.generator.set_state(post)

    def _fingerprint_skip(self, step0: int, out: dict) -> None:
        """A skipped step's record in result_dir/skips.jsonl, with the JAX
        Runner's fields: its 0-based global_step, in_chunk (0: the port
        runs one step at a time), the loss (a string where not finite) and
        the leaves that were not finite; with skip_probe the probe's
        verdict and which state it replayed."""
        lv = out["loss"]
        row = {"global_step": int(step0), "in_chunk": 0,
               "loss": lv if math.isfinite(lv) else repr(lv),
               "bad_leaves": out["bad_leaves"]}
        if "probe" in out:
            row["probe"] = out["probe"]
            row["probe_replayed"] = "the pre-step state"
        self._say(f"  skip fingerprint: {json.dumps(row)}")
        if not self.writes:
            return
        try:
            with open(os.path.join(self.cfg.result_dir, "skips.jsonl"),
                      "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            pass

    # -- loop ----------------------------------------------------------------

    def _say(self, msg: str) -> None:
        """Prints ``msg`` (under the mesh on rank 0 only)."""
        if self.writes:
            print(msg, flush=True)

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
                self._say(f"step {step}: step REJECTED (non-finite loss or "
                          f"gradients), state carried unchanged "
                          f"({self.skipped_steps} total)")
                self._fingerprint_skip(step0, out)
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
                    self._say(f"step {step}: eval " + json.dumps(m))
            if step < max_steps and step in cfg.save_steps:
                self.save_checkpoint(step)
            if log_every and step % log_every == 0:
                self._say(f"step {step}: loss {out['loss']:.4f} isects "
                          f"{out['n_isects']} ({time.time() - t0:.1f}s)")
            self._log(step, out)
        return losses

    def _log(self, step: int, out: dict) -> None:
        """The train/* scalars at tb_every and the parameters' histograms
        at tb_histograms_every (after ``step`` steps)."""
        cfg = self.cfg
        if cfg.tb_every and step % cfg.tb_every == 0:
            self.logger.scalars(
                {"train/loss": out["loss"], "train/n_isects": out["n_isects"],
                 "train/num_GS": self._num_live(),
                 "train/skipped_steps": self.skipped_steps}, step)
        if cfg.tb_histograms_every and step % cfg.tb_histograms_every == 0:
            for name in ("means", "scales", "opacities"):
                self.logger.histogram(
                    f"params/{name}", self._gather(
                        {name: self.splats[name]})[name].detach().cpu()
                    .numpy(), step)

    def _num_live(self) -> int:
        """The live slots of the whole model (summed over the ranks)."""
        n = torch.tensor(num_live(self.splats), dtype=torch.int64,
                         device=self.device)
        return int(self.mesh.all_reduce(n)) if self.mesh is not None \
            else int(n)

    def _refine(self, step: int) -> None:
        """The strategy's refine on the whole model: under the mesh every
        rank gathers the per-Gaussian state, refines it with the shared
        generator (so every rank computes the same bits) and keeps its
        rows."""
        new = self.strategy.refine(
            self._gather(self.splats), self._gather(self.opt_states),
            self._gather(self.strategy_state), step,
            generator=self.refine_generator)
        # the same finite gate as the step, on the refined parameters
        if all(bool(torch.isfinite(v).all()) for v in new[0].values()):
            event = {"step": step, "event": "refine",
                     "live": num_live(new[0])}
            if "allocated" in new[2]:
                event["allocated"] = int(new[2]["allocated"].sum())
            self.splats, self.opt_states, self.strategy_state = [
                self._shard(t) for t in new]
            self.events.append(event)
            self.logger.scalars({"refine/allocated": event.get(
                "allocated", event["live"]), "refine/live": event["live"]},
                step)
        else:
            self._say(f"step {step}: refine REJECTED (non-finite "
                      f"parameters)")
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
            self._say(f"step {step}: ISECT OVERFLOW ({n_isects} >= 95% of "
                      f"{cap}), capacity doubles")
        else:
            self._say(f"step {step}: isect buffer saturated ({n_isects} >= "
                      f"95% of {cap}, growth bound reached), deepest "
                      f"intersections truncate")

    # -- eval --------------------------------------------------------------

    def _eval_splats(self) -> Dict[str, torch.Tensor]:
        """The whole model's splats: under the mesh gathered on every rank
        (a collective: every rank calls it)."""
        return self._gather(self.splats)

    def render_view(self, camtoworld, K, width: int, height: int,
                    sh_degree: Optional[int] = None,
                    splats: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """[H, W, 3] render of the current splats (or of ``splats``, the
        whole model), clipped to [0, 1]; with appearance, through its MLP
        with the zero (average) embedding. Under the mesh every rank calls
        it and renders the gathered model."""
        cfg = self.cfg
        sh = cfg.sh_degree if sh_degree is None else sh_degree
        dev = self.device
        splats = self._eval_splats() if splats is None else splats
        with torch.no_grad():
            means, quats, scales, opac = splat_activations(splats)
            c2w = _tensor(camtoworld, dev)
            if cfg.app_opt:
                dirs = means[None, :, :] - c2w[None, None, :3, 3]
                colors = torch.sigmoid(appearance_opt_apply(
                    torch.zeros((1, cfg.app_embed_dim), device=dev),
                    self.app_mlp(self.aux_params), splats["features"],
                    torch.zeros(1, dtype=torch.long, device=dev), dirs, sh,
                    sh_degree_max=cfg.sh_degree)
                    + splats["colors"][None])
                sh = None
            else:
                colors = torch.cat([splats["sh0"], splats["shN"]], 1)
            img, _, _ = rasterization(
                means, quats, scales, opac, colors,
                torch.linalg.inv(c2w)[None], _tensor(K, dev)[None], width,
                height, sh_degree=sh, isect_capacity=self.isect_capacity(),
                rasterizer=cfg.rasterizer, tile_size=cfg.tile_size,
                device=dev)
        return torch.clamp(img[0], 0.0, 1.0)

    def _lpips_weights(self) -> Optional[Dict[str, torch.Tensor]]:
        """LPIPS's weights from GSC_LPIPS_WEIGHTS (training/lpips.py), or
        None, and then, once a runner, a notice that eval skips it."""
        if lpips_available():
            return load_lpips_weights(device=self.device)
        if not getattr(self, "_lpips_notice_printed", False):
            self._say("eval: lpips SKIPPED (no weights at GSC_LPIPS_WEIGHTS; "
                      "psnr/ssim only)")
            self._lpips_notice_printed = True
        return None

    def eval(self, stage: str = "val") -> Dict[str, float]:
        """Mean PSNR and SSIM over the validation views, and LPIPS where
        its weights are found (``_lpips_weights``); also written to
        result_dir/stats/<stage>.json. With eval_save_images each view's
        render beside its target goes to result_dir/renders/
        <stage>_<i>.png. Under the mesh every rank evaluates the gathered
        model and rank 0 writes."""
        lpips_w = self._lpips_weights()
        metrics = {"psnr": [], "ssim": []}
        if lpips_w is not None:
            metrics["lpips"] = []
        # the whole model, gathered once (under the mesh)
        kw = {"splats": self._eval_splats()} if self.mesh is not None \
            else {}
        for i in range(len(self.valset)):
            data = self.valset[i]
            tgt = _tensor(data["image"], self.device)
            h, w = tgt.shape[:2]
            img = self.render_view(data["camtoworld"], data["K"], w, h, **kw)
            with torch.no_grad():
                metrics["psnr"].append(float(psnr(img, tgt)))
                metrics["ssim"].append(float(ssim(img[None], tgt[None])))
                if lpips_w is not None:
                    metrics["lpips"].append(float(lpips(img[None], tgt[None],
                                                        lpips_w)))
            if self.cfg.eval_save_images and self.writes:
                rdir = os.path.join(self.cfg.result_dir, "renders")
                os.makedirs(rdir, exist_ok=True)
                pair = np.concatenate([img.cpu().numpy(),
                                       np.asarray(data["image"])], axis=1)
                write_png(os.path.join(rdir, f"{stage}_{i:04d}.png"),
                          (np.clip(pair, 0, 1) * 255).astype(np.uint8))
        out = {k: float(np.mean(v)) for k, v in metrics.items()}
        if self.writes:
            stats_dir = os.path.join(self.cfg.result_dir, "stats")
            os.makedirs(stats_dir, exist_ok=True)
            with open(os.path.join(stats_dir, f"{stage}.json"), "w") as f:
                json.dump(out, f)
        return out

    def render_traj(self, step: int = 0, traj: str = "interp",
                    n_frames: int = 120) -> str:
        """Renders a camera path made from the parser's poses ("interp"
        through them, "ellipse" or "spiral" around them) at the first
        validation view's intrinsics and size (the first training view's
        where there is none), into result_dir/videos: traj_<traj>_<step>.mp4
        at 30 fps where imageio writes mp4, else the folder
        traj_<traj>_<step> of PNG frames. Returns the path."""
        from gscodec_studio_tpu_torch.datasets.traj import (
            generate_ellipse_path, generate_interpolated_path,
            generate_spiral_path)

        c2ws = np.asarray(self.parser.camtoworlds)
        if traj == "interp":
            n_interp = max(n_frames // max(len(c2ws) - 1, 1), 1)
            path = generate_interpolated_path(c2ws, n_interp)
        elif traj == "ellipse":
            path = generate_ellipse_path(c2ws, n_frames)
        else:
            path = generate_spiral_path(c2ws, n_frames)
        d0 = self.valset[0] if len(self.valset) else self.trainset[0]
        K = np.asarray(d0["K"])
        h, w = np.asarray(d0["image"]).shape[:2]
        kw = {"splats": self._eval_splats()} if self.mesh is not None \
            else {}
        frames = [(np.clip(self.render_view(c2w, K, w, h, **kw).cpu()
                           .numpy(), 0, 1) * 255).astype(np.uint8)
                  for c2w in path]
        if not self.writes:
            return ""
        out_dir = os.path.join(self.cfg.result_dir, "videos")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"traj_{traj}_{step}.mp4")
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(out, frames, fps=30)
        except Exception:  # no imageio, or no mp4 writer: PNG frames
            out = os.path.join(out_dir, f"traj_{traj}_{step}")
            os.makedirs(out, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(out, f"{i:04d}.png"), f)
        return out

    # -- checkpoint / export -----------------------------------------------

    def live_splats(self) -> Dict[str, np.ndarray]:
        """Host copies of the live splats: the slots whose opacity is above
        0.005 (under the mesh, of the gathered model, on every rank)."""
        splats = {k: v.detach().cpu().numpy()
                  for k, v in self._eval_splats().items()}
        keep = 1.0 / (1.0 + np.exp(-splats["opacities"])) > 0.005
        return {k: v[keep] for k, v in splats.items()}

    def _ckpt_leaves(self):
        """(key, tree, name) of each checkpoint leaf: ``splats/<name>``,
        then the sim and the per-image modules' parameters as ``sim/<i>``
        and ``aux/<i>``, numbered in the JAX pytree's flatten order
        (models.splats.jax_leaf_order; aux: app_embeds, app_mlp.0.b,
        app_mlp.0.w, app_mlp.1.b, app_mlp.1.w, bilagrid, pose)."""
        out = [(f"splats/{k}", self.splats, k) for k in self.splats]
        for prefix, tree in (("sim", self.sim_params),
                             ("aux", self.aux_params)):
            out += [(f"{prefix}/{i}", tree, k)
                    for i, k in enumerate(jax_leaf_order(tree))]
        return out

    def save_checkpoint(self, step: int) -> str:
        """result_dir/ckpts/ckpt_<step>.npz with the JAX package's keys:
        ``step``, ``splats/<name>``, ``sim/<i>`` and ``aux/<i>``
        (_ckpt_leaves). The model only, no optimizer state, as the JAX
        package saves it. Returns the path. Under the mesh every rank calls
        it and rank 0 writes the gathered model."""
        ckpt_dir = os.path.join(self.cfg.result_dir, "ckpts")
        path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
        splats = self._eval_splats()
        arrs = {key: (splats[name] if key.startswith("splats/")
                      else tree[name]).detach().cpu().numpy()
                for key, tree, name in self._ckpt_leaves()}
        if self.writes:
            os.makedirs(ckpt_dir, exist_ok=True)
            np.savez(path, step=step, **arrs)
        return path

    def load_checkpoint(self, path: str) -> int:
        """Loads the splats, the sim parameters and the per-image modules
        of a checkpoint of either package onto the runner's device; returns
        its step. Each leaf must have the shape of the runner's own (the
        same capacity and configuration); a checkpoint without ``aux/``
        leaves leaves the modules as they are, as the JAX Runner does. Under
        the mesh each rank keeps its rows of the splats."""
        dev = self.device
        with np.load(path) as z:
            leaves = [(key, tree, name)
                      for key, tree, name in self._ckpt_leaves()
                      if not key.startswith("aux/") or "aux/0" in z.files]
            loaded = {}
            for key, tree, name in leaves:
                want = tuple(tree[name].shape)
                if key.startswith("splats/"):
                    want = (self.cap,) + want[1:]
                got = z[key].shape if key in z.files else "missing"
                if got != want:
                    raise ValueError(f"{path}: {key} is {got}, the "
                                     f"runner's {name} {want}")
                loaded[key] = torch.as_tensor(z[key], dtype=torch.float32,
                                              device=dev)
                if key.startswith("splats/"):
                    loaded[key] = self._shard({name: loaded[key]})[name]
            step = int(z["step"])
        for key, tree, name in leaves:
            tree[name] = loaded[key]
        return step

    def save_ply(self, path: str) -> None:
        """The live splats as an Inria-layout binary PLY. It holds SH
        colours, which the appearance path (app_opt: features and colors
        through an MLP) does not have: there it raises."""
        if "sh0" not in self.splats:
            raise ValueError("save_ply writes SH colours; under app_opt the "
                             "splats carry features and colors instead")
        live = self.live_splats()
        if self.writes:
            save_ply(path, live)

    # -- test-time compression ---------------------------------------------

    def run_compression(self, step: int = 0,
                        method: str = "png") -> Dict[str, float]:
        """Compress the live splats into result_dir/compression_<step>
        with the PNG codec (``method="png"``) or the rANS codec
        (``"entropy_coding"``: histogram tables without the compression
        simulation's entropy models, else the factorized models' tables,
        or under ``entropy_model_type="gaussian_model"`` the hash-grid
        models' context tables), decode them, pad them back to capacity
        (dead slots at opacity -15), evaluate them as stage
        ``compress_<method>`` and restore the trained splats. Returns the
        metrics with ``size_bytes``, the bitstream's bytes on disk; the
        stages' seconds are left in ``self.compression_seconds``. Under the
        mesh rank 0 compresses the gathered model, every rank decodes it
        and keeps its rows, and the ranks evaluate the decoded model."""
        compress_dir = os.path.join(self.cfg.result_dir,
                                    f"compression_{step}")
        if method == "png":
            codec = PngCompression(device=self.device)
            args = {}
        elif method == "entropy_coding":
            codec = EntropyCodingCompression(device=self.device)
            args = {"entropy_models": self.entropy_models()}
        else:
            raise ValueError(method)
        live = self.live_splats()
        if self.writes:
            codec.compress(compress_dir, live, **args)
        if self.mesh is not None:
            self.mesh.barrier()  # the stream is on disk
        t0 = time.perf_counter()
        decoded = codec.decompress(compress_dir)
        restored = {}
        for k, v in self.splats.items():
            arr = np.zeros((self.cap,) + tuple(v.shape[1:]), np.float32)
            if arr.size and k in decoded:
                dec = decoded[k].reshape((-1,) + tuple(v.shape[1:]))
                arr[:len(dec)] = dec
                if k == "opacities":
                    arr[len(dec):] = DEAD_OPACITY_LOGIT
            restored[k] = torch.as_tensor(arr, device=self.device)
        restored = self._shard(restored)
        seconds = dict(getattr(codec, "seconds", {}),
                       decode=time.perf_counter() - t0)
        backup = self.splats
        self.splats = restored
        t0 = time.perf_counter()
        try:
            metrics = self.eval(stage=f"compress_{method}")
        finally:
            self.splats = backup
        seconds["eval"] = time.perf_counter() - t0
        self.compression_seconds = seconds
        metrics["size_bytes"] = compressed_size(compress_dir)
        return metrics

    def entropy_models(self) -> Optional[Dict]:
        """The rANS codec's models of the compression simulation: {attr:
        factorized model} or, under the hash-grid model, {attr:
        ("gaussian", (model, cfgs))}; None without entropy models."""
        sim = self.compression_sim
        if sim is None or not sim.entropy_model_opt:
            return None
        out = {}
        for name in sim.entropy_channels:
            model = entropy_model_params(self.sim_params, name)
            if not model:
                continue
            if sim.entropy_model_type == "gaussian_model":
                model = ("gaussian", (model, gaussian_conditional_cfgs(model)))
            out[name] = model
        return out or None
