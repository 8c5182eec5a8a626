"""Training-time compression simulation (port of
gscodec_studio_tpu/compression_sim/simulation.py): per-attribute fake
quantization with the reference's bitwidth and bound tables, optional
learned factorized entropy models whose estimated bits enter the loss as
rd_lambda * mean bits, and the learnable shN annealing mask.

The learnable state is an explicit ``sim_params`` dict of tensors, flat:
"entropy.<attr>.<matrices|biases|factors>.<i>" for each entropy model and
"ada_mask" for the mask logits. The trainer optimizes it with
``build_optimizer``'s Adam(1e-4) beside the splats; ``simulate`` is a pure
function of the splats, the sim parameters and the step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.compression_sim.ada_mask import (
    annealing_mask_apply, annealing_mask_sparsity_loss)
from gscodec_studio_tpu_torch.compression_sim.entropy_model import (
    factorized_bits, init_factorized)
from gscodec_studio_tpu_torch.compression_sim.ops import fake_quantize_ste
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
ENTROPY_PARTS = ("matrices", "biases", "factors")


def entropy_model_params(sim_params: Dict[str, torch.Tensor],
                         name: str) -> Dict:
    """The factorized model of attribute ``name`` as entropy_model takes
    it, from the flat sim_params."""
    out = {}
    for part in ENTROPY_PARTS:
        prefix = f"entropy.{name}.{part}."
        keys = sorted((k for k in sim_params if k.startswith(prefix)),
                      key=lambda k: int(k[len(prefix):]))
        out[part] = [sim_params[k] for k in keys]
    return out


def flatten_entropy_model(name: str, model: Dict) -> Dict[str, torch.Tensor]:
    return {f"entropy.{name}.{part}.{i}": t for part in ENTROPY_PARTS
            for i, t in enumerate(model[part])}


@dataclasses.dataclass
class CompressionSimulation:
    entropy_model_opt: bool = False
    shN_ada_mask_opt: bool = False
    cap: int = 0
    max_steps: int = 30_000
    ada_mask_start: int = 10_000
    q_type: str = "round"
    # "factorized_model", or "gaussian_model" (hash-grid conditioned; not
    # ported yet)
    entropy_model_type: str = "factorized_model"
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
        if self.entropy_model_opt and \
                self.entropy_model_type == "gaussian_model":
            raise NotImplementedError(
                "entropy_model_type='gaussian_model' (hash_grid.py, "
                "gaussian_bits) is not ported yet: ROADMAP A7")
        if self.entropy_model_type not in ("factorized_model",
                                           "gaussian_model"):
            raise ValueError(
                f"unknown entropy_model_type {self.entropy_model_type!r}")

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, torch.Tensor]:
        """The learnable simulation parameters: one factorized model per
        entropy channel group (biases drawn from ``generator``) and the mask
        logits at 1."""
        out = {}
        if self.entropy_model_opt:
            for name, c in self.entropy_channels.items():
                filters = (3, 3) if name in ("scales", "sh0") else (3, 3, 3)
                out.update(flatten_entropy_model(name, init_factorized(
                    c, filters, generator=generator, device=device)))
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
                    and model["matrices"]:
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
