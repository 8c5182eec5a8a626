"""Training-time compression simulation (port of
gscodec_studio_tpu/compression_sim/simulation.py): per-attribute fake
quantization with the reference's bitwidth and bound tables, optional
learned entropy models whose estimated bits enter the loss as
rd_lambda * mean bits, and the learnable shN annealing mask.

The entropy model of each attribute is factorized (entropy_model.py) or,
with entropy_model_type="gaussian_model", a Gaussian whose mean and scale a
hash grid and an MLP regress from the position (hash_grid.py); the latter
scores a subsample of rows a step, drawn by ``sample_subset``.

The learnable state is an explicit ``sim_params`` dict of tensors, flat,
named by models.splats.flatten_tree: "entropy.<attr>.<matrices|biases|
factors>.<i>" for a factorized model, "entropy.<attr>.grid3d",
"entropy.<attr>.planes.<i>" and "entropy.<attr>.mlp.<i>.<w|b>" for a
hash-grid one, and "ada_mask" for the mask logits. The trainer optimizes
it with ``build_optimizer``'s Adam(1e-4) beside the splats; ``simulate``
is a function of the splats, the sim parameters, the step and the
generator that the draws come from. ``STGCompressionSimulation`` is the
same simulation with the tables of the dynamic (STG) splats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.compression_sim.ada_mask import (
    annealing_mask_apply, annealing_mask_sparsity_loss)
from gscodec_studio_tpu_torch.compression_sim.entropy_model import (
    factorized_bits, init_factorized)
from gscodec_studio_tpu_torch.compression_sim.hash_grid import (
    gaussian_conditional_bits, gaussian_conditional_cfgs,
    gaussian_conditional_init)
from gscodec_studio_tpu_torch.compression_sim.ops import fake_quantize_ste
from gscodec_studio_tpu_torch.models.splats import (flatten_tree,
                                                    unflatten_tree)
from gscodec_studio_tpu_torch.optimizers.builders import AdamGroup

# Per-attribute quantization tables, as the JAX package's.
SIM_OPTION = {
    "means": False, "scales": True, "quats": True, "opacities": True,
    "sh0": True, "shN": False,
}
Q_BITWIDTH = {"scales": 8, "quats": 8, "opacities": 8, "sh0": 8}
BOUNDS = {
    "scales": (-10.0, 2.0),
    "quats": (-1.0, 1.0),
    "opacities": (-15.0, 15.0),
    "sh0": (-2.0, 4.0),
}
ENTROPY_OPTION = {"scales": True, "quats": True, "opacities": False,
                  "sh0": True}
# Steps after which each attribute's entropy term joins the loss.
ENTROPY_STEPS = {"quats": 10_000, "scales": 10_000, "sh0": 20_000}
# the hash-grid model's levels (the JAX package's simulation sets these)
GAUSSIAN_LEVELS_3D, GAUSSIAN_LEVELS_2D = 8, 2
POSITION_QUANTILES = (0.01, 0.99)  # the positions' normalization bounds


def entropy_model_params(sim_params: Dict[str, torch.Tensor],
                         name: str) -> Dict:
    """The entropy model of attribute ``name`` as a tree, as entropy_model
    and hash_grid take it, from the flat sim_params ({} if it has none)."""
    return unflatten_tree(sim_params, f"entropy.{name}.")


def flatten_entropy_model(name: str, model: Dict) -> Dict[str, torch.Tensor]:
    return flatten_tree(model, f"entropy.{name}.")


def sample_subset(k: int, n: int, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """The gaussian_model's k row indices, uniform in [0, n) with
    replacement (the JAX package draws them with jax.random.randint);
    tests replace this draw with JAX's."""
    return torch.randint(0, n, (k,), generator=generator, device=device)


@dataclasses.dataclass
class CompressionSimulation:
    entropy_model_opt: bool = False
    shN_ada_mask_opt: bool = False
    cap: int = 0
    max_steps: int = 30_000
    ada_mask_start: int = 10_000
    q_type: str = "round"
    # "factorized_model" | "gaussian_model" (hash-grid conditioned)
    entropy_model_type: str = "factorized_model"
    # gaussian_model scores this many rows a step (drawn by sample_subset)
    gaussian_sample: int = 16_384
    sim_option: Dict = dataclasses.field(
        default_factory=lambda: dict(SIM_OPTION))
    q_bitwidth: Dict = dataclasses.field(
        default_factory=lambda: dict(Q_BITWIDTH))
    bounds: Dict = dataclasses.field(default_factory=lambda: dict(BOUNDS))
    entropy_option: Dict = dataclasses.field(
        default_factory=lambda: dict(ENTROPY_OPTION))
    entropy_steps: Dict = dataclasses.field(
        default_factory=lambda: dict(ENTROPY_STEPS))
    entropy_channels: Dict = dataclasses.field(
        default_factory=lambda: {"scales": 3, "quats": 4, "sh0": 3})

    def __post_init__(self):
        if self.entropy_model_type not in ("factorized_model",
                                           "gaussian_model"):
            raise ValueError(
                f"unknown entropy_model_type {self.entropy_model_type!r}")

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, torch.Tensor]:
        """The learnable simulation parameters, drawn from ``generator``:
        one entropy model per entropy channel group (factorized, or the
        hash-grid Gaussian model) and the mask logits at 1."""
        out = {}
        if self.entropy_model_opt:
            for name, c in self.entropy_channels.items():
                if self.entropy_model_type == "gaussian_model":
                    model, _ = gaussian_conditional_init(
                        c, n_levels_3d=GAUSSIAN_LEVELS_3D,
                        n_levels_2d=GAUSSIAN_LEVELS_2D, generator=generator,
                        device=device)
                else:
                    filters = (3, 3) if name in ("scales", "sh0") \
                        else (3, 3, 3)
                    model = init_factorized(c, filters, generator=generator,
                                            device=device)
                out.update(flatten_entropy_model(name, model))
        if self.shN_ada_mask_opt:
            out["ada_mask"] = torch.ones(self.cap, dtype=torch.float32,
                                         device=device)
        return out

    def build_optimizer(self, sim_params: Dict[str, torch.Tensor]):
        """Adam(1e-4) with optax's defaults for every sim parameter:
        ({name: AdamGroup}, {name: state}) for optimizers.apply_updates."""
        group = AdamGroup(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8)
        return ({k: group for k in sim_params},
                {k: {"count": 0, "exp_avg": torch.zeros_like(v),
                     "exp_avg_sq": torch.zeros_like(v)}
                 for k, v in sim_params.items()})

    def simulate(self, splats: Dict[str, torch.Tensor],
                 sim_params: Optional[Dict[str, torch.Tensor]], step: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor]:
        """Returns (fake-quantized splats, total mean estimated bits,
        auxiliary losses). ``step`` is the 0-based step; q_type "noise"
        draws its uniforms from ``generator``."""
        dev = splats["means"].device
        new = dict(splats)
        total_bits = torch.zeros((), device=dev)
        aux = torch.zeros((), device=dev)
        sim_params = sim_params or {}
        for name in sorted(splats):  # the JAX pytree's key order
            if not self.sim_option.get(name, False):
                continue
            lo, hi = self.bounds[name]
            x = splats[name]
            x2 = x.reshape(x.shape[0], -1)
            uniform = None
            if self.q_type == "noise":
                uniform = torch.rand(x2.shape, generator=generator,
                                     device=dev) - 0.5
            xq, q_step = fake_quantize_ste(x2, lo, hi, self.q_bitwidth[name],
                                           self.q_type, uniform)
            new[name] = xq.reshape(x.shape)
            model = entropy_model_params(sim_params, name)
            if self.entropy_model_opt and self.entropy_option.get(name) \
                    and model:
                if self.entropy_model_type == "gaussian_model":
                    bits = self._gaussian_bits(model, splats["means"], xq,
                                               q_step, generator)
                else:
                    bits = factorized_bits(model, xq, q_step)
                gate = float(step > self.entropy_steps[name])
                total_bits = total_bits + gate * bits.mean()
        if self.shN_ada_mask_opt and "ada_mask" in sim_params:
            kw = dict(total_iters=self.max_steps,
                      annealing_start_iter=self.ada_mask_start)
            if step > self.ada_mask_start:
                new["shN"] = annealing_mask_apply(
                    sim_params["ada_mask"], splats["shN"], step, **kw)
                aux = aux + annealing_mask_sparsity_loss(
                    sim_params["ada_mask"], step, **kw)
        return new, total_bits, aux

    def _gaussian_bits(self, model: Dict, means: torch.Tensor,
                       xq: torch.Tensor, q_step: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The hash-grid model's bits on a subsample of rows, conditioned on
        their positions normalized by the 1%/99% quantiles of all
        positions (torch.quantile's linear rule, jnp.percentile's default)
        and clipped to [0, 1]. The grid is read through the STE sign
        (binarize=True), the 1-bit grid the entropy coder would ship."""
        n = xq.shape[0]
        idx = sample_subset(min(self.gaussian_sample, n), n, generator,
                            xq.device)
        q = torch.tensor(POSITION_QUANTILES, dtype=means.dtype,
                         device=means.device)
        lo_p, hi_p = torch.quantile(means, q, dim=0)
        pos = torch.clamp((means[idx] - lo_p)
                          / torch.clamp(hi_p - lo_p, min=1e-6), 0.0, 1.0)
        return gaussian_conditional_bits(model,
                                         gaussian_conditional_cfgs(model),
                                         xq[idx], pos, q_step, binarize=True)


# The STG (dynamic splat) tables: scales, quats, opacities and the colour,
# direction and time features are quantized; the temporal parameters
# (trbf_center, trbf_scale, motion, omega) and the means are not. The
# entropy terms join the loss after step 7,000.
STG_SIM_OPTION = {
    "means": False, "scales": True, "quats": True, "opacities": True,
    "trbf_center": False, "trbf_scale": False, "motion": False,
    "omega": False, "colors": True, "features_dir": True,
    "features_time": True,
}
STG_Q_BITWIDTH = {
    "scales": 8, "quats": 8, "opacities": 8, "colors": 8,
    "features_dir": 8, "features_time": 8,
}
STG_BOUNDS = {
    "scales": (-10.0, 2.0),
    "quats": (-1.0, 1.0),
    "opacities": (-7.0, 7.0),
    "colors": (-7.5, 7.5),
    "features_dir": (-10.0, 10.0),
    "features_time": (-10.0, 10.0),
}
STG_ENTROPY_OPTION = {
    "scales": True, "quats": True, "opacities": False, "colors": True,
    "features_dir": True, "features_time": True,
}
STG_ENTROPY_STEPS = {
    "scales": 7_000, "quats": 7_000, "colors": 7_000,
    "features_dir": 7_000, "features_time": 7_000,
}
STG_ENTROPY_CHANNELS = {
    "scales": 3, "quats": 4, "colors": 3, "features_dir": 3,
    "features_time": 3,
}


def STGCompressionSimulation(**kw) -> CompressionSimulation:
    """The simulation with the STG tables (any of them may be given)."""
    kw.setdefault("sim_option", dict(STG_SIM_OPTION))
    kw.setdefault("q_bitwidth", dict(STG_Q_BITWIDTH))
    kw.setdefault("bounds", dict(STG_BOUNDS))
    kw.setdefault("entropy_option", dict(STG_ENTROPY_OPTION))
    kw.setdefault("entropy_steps", dict(STG_ENTROPY_STEPS))
    kw.setdefault("entropy_channels", dict(STG_ENTROPY_CHANNELS))
    return CompressionSimulation(**kw)
