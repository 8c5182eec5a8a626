"""Slot-based densification primitives at a static capacity (port of
gscodec_studio_tpu/strategy/ops.py: allocate_slots, scatter_rows,
copy_to_slots, split_to_slots, remove_slots, reset_opacities, and MCMC's
relocate_dead and inject_noise_to_position).

The splat tensors keep their capacity ``cap``; dead slots are recycled.
``opt_states`` is {name: {"count", "exp_avg", "exp_avg_sq"}}
(optimizers/builders.py): every moment tensor whose leading dimension is
cap gets the same row edits as the parameters, new rows zeroed, and the
step counts stay. Each op returns new tensors and leaves its inputs as
they were. Every random draw is an argument (``split_to_slots``' normals,
``relocate_dead``'s sampled sources, ``inject_noise_to_position``'s
normals), so that the tests can hand both packages the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from gscodec_studio_tpu_torch.models.splats import DEAD_OPACITY_LOGIT
from gscodec_studio_tpu_torch.ops.quat import (quat_scale_to_covar,
                                               quat_to_rotmat)
from gscodec_studio_tpu_torch.ops.relocation import compute_relocation

Params = Dict[str, torch.Tensor]
OptStates = Dict[str, dict]


def _map_cap_leaves(state: dict, cap: int, fn: Callable) -> dict:
    return {k: fn(v) if isinstance(v, torch.Tensor) and v.ndim >= 1
            and v.shape[0] == cap else v for k, v in state.items()}


def map_opt_states(opt_states: OptStates, cap: int,
                   fn: Callable) -> OptStates:
    return {k: _map_cap_leaves(v, cap, fn) for k, v in opt_states.items()}


def allocate_slots(free: torch.Tensor, want: torch.Tensor):
    """Give the k-th wanting slot the k-th free slot. Returns (dst int32
    [cap]: the target slot of each wanting source, or cap where no free slot
    is left; ok bool [cap]: the wants that got a slot)."""
    cap = free.shape[0]
    free_idx = torch.sort((~free).to(torch.int8), stable=True).indices
    n_free = free.sum()
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < n_free)
    dst = torch.where(ok, free_idx[torch.clamp(rank, 0, cap - 1)],
                      torch.full_like(free_idx, cap))
    return dst.to(torch.int32), ok


def scatter_rows(x: torch.Tensor, dst: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """x with rows dst set to values; dst == cap drops the row."""
    out = torch.cat([x, torch.zeros_like(x[:1])], 0)
    out[dst.to(torch.int64)] = values
    return out[:-1]


def _row_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def copy_to_slots(params: Params, opt_states: OptStates,
                  dst: torch.Tensor) -> Tuple[Params, OptStates]:
    """Duplicate: write every row into its destination slot (dst == cap
    drops it); the destinations' moments are zeroed."""
    cap = dst.shape[0]
    params = {k: scatter_rows(v, dst, v) for k, v in params.items()}
    opt_states = map_opt_states(
        opt_states, cap,
        lambda x: scatter_rows(x, dst, torch.zeros_like(x)))
    return params, opt_states


def split_to_slots(params: Params, opt_states: OptStates, sel: torch.Tensor,
                   dst: torch.Tensor, samples: torch.Tensor,
                   revised_opacity: bool = False
                   ) -> Tuple[Params, OptStates]:
    """Split each selected Gaussian in two: children offset by the parent's
    covariance applied to ``samples`` (standard normal [2, cap, 3], drawn by
    the caller), scales / 1.6. Child 1 replaces the parent; child 2 goes to
    the free slot ``dst``. Both children's moments are zeroed."""
    cap = sel.shape[0]
    scales = torch.exp(params["scales"])
    R = quat_to_rotmat(params["quats"])
    offsets = torch.einsum("nij,snj->sni", R, samples * scales[None])
    new_means = params["means"][None] + offsets
    new_scales = torch.log(scales / 1.6)
    if revised_opacity:
        op = torch.sigmoid(params["opacities"])
        new_op = 1.0 - torch.sqrt(torch.clamp(1.0 - op, 1e-12, 1.0))
        new_logit = torch.log(new_op / torch.clamp(1.0 - new_op, 1e-12, 1.0))
    else:
        new_logit = params["opacities"]

    params = dict(params)
    params["means"] = torch.where(sel[:, None], new_means[0], params["means"])
    params["scales"] = torch.where(sel[:, None], new_scales, params["scales"])
    params["opacities"] = torch.where(sel, new_logit, params["opacities"])
    opt_states = map_opt_states(
        opt_states, cap,
        lambda x: torch.where(_row_mask(sel, x), torch.zeros_like(x), x))

    child2 = dict(params, means=new_means[1], scales=new_scales,
                  opacities=new_logit)
    params = {k: scatter_rows(v, dst, child2[k]) for k, v in params.items()}
    opt_states = map_opt_states(
        opt_states, cap,
        lambda x: scatter_rows(x, dst, torch.zeros_like(x)))
    return params, opt_states


def remove_slots(params: Params, opt_states: OptStates,
                 kill: torch.Tensor) -> Tuple[Params, OptStates]:
    """Prune: the killed slots become dead (opacity logit
    DEAD_OPACITY_LOGIT), invisible and free for reuse; their moments are
    zeroed."""
    cap = kill.shape[0]
    params = dict(params)
    params["opacities"] = torch.where(
        kill, torch.full_like(params["opacities"], DEAD_OPACITY_LOGIT),
        params["opacities"])
    opt_states = map_opt_states(
        opt_states, cap,
        lambda x: torch.where(_row_mask(kill, x), torch.zeros_like(x), x))
    return params, opt_states


def reset_opacities(params: Params, opt_states: OptStates, value: float,
                    alive: torch.Tensor) -> Tuple[Params, OptStates]:
    """Clamp live opacities to ``value``; zero only the opacity group's
    moments."""
    cap = alive.shape[0]
    logit = torch.log(torch.tensor(value / (1 - value), dtype=torch.float32))
    params = dict(params)
    params["opacities"] = torch.where(
        alive, torch.clamp(params["opacities"], max=float(logit)),
        params["opacities"])
    opt_states = dict(opt_states)
    if "opacities" in opt_states:
        opt_states["opacities"] = _map_cap_leaves(
            opt_states["opacities"], cap, torch.zeros_like)
    return params, opt_states


def sample_sources(opacities: torch.Tensor, dead: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The relocation's draw: for every slot, a source index (int64 [cap])
    sampled with replacement by opacity among the slots that are not
    ``dead``. The JAX package draws jax.random.categorical over their log
    opacities clipped to [1e-12, 1], the same distribution. With every slot
    dead each slot is its own source, and the relocation changes nothing."""
    op = torch.sigmoid(opacities)
    w = torch.where(dead, torch.zeros_like(op), torch.clamp(op, 1e-12, 1.0))
    if not bool(w.sum() > 0):
        return torch.arange(op.shape[0], device=op.device)
    return torch.multinomial(w, op.shape[0], replacement=True,
                             generator=generator)


def relocate_dead(params: Params, opt_states: OptStates,
                  sampled: torch.Tensor, dead: torch.Tensor,
                  min_opacity: float = 0.005, binoms_n_max: int = 51
                  ) -> Tuple[Params, OptStates]:
    """MCMC relocation: each ``dead`` slot becomes a clone of its source
    ``sampled[slot]`` (int64 [cap], see sample_sources); a source and its
    clones share the opacity 1-(1-o)^(1/ratio), clamped at min_opacity, and
    the Eq. 9-shrunk scales. The moments of dead and sampled slots are
    zeroed."""
    cap = params["opacities"].shape[0]
    op = torch.sigmoid(params["opacities"])
    sampled = sampled.to(torch.int64)
    target = torch.where(dead, sampled, torch.full_like(sampled, cap))
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=op.device)
    counts = counts.index_add_(0, target, torch.ones_like(target))[:cap]
    ratios = torch.clamp(counts + 1, 1, binoms_n_max)
    new_op, new_scales = compute_relocation(
        torch.clamp(op, min_opacity, 1.0), torch.exp(params["scales"]),
        ratios, binoms_n_max)
    # The clamp at min_opacity (the JAX package's fix f4a915e): a source
    # near the death threshold would otherwise split into slots below it,
    # dead on arrival and relocated again at every refine.
    new_op = torch.clamp(new_op, min_opacity, 1 - 1e-7)
    new_logit = torch.log(new_op / (1 - new_op))
    new_log_scales = torch.log(torch.clamp(new_scales, min=1e-20))

    was_sampled = counts > 0
    params = dict(params)
    params["opacities"] = torch.where(was_sampled, new_logit,
                                      params["opacities"])
    params["scales"] = torch.where(was_sampled[:, None], new_log_scales,
                                   params["scales"])
    params = {k: torch.where(_row_mask(dead, v), v[sampled], v)
              for k, v in params.items()}
    touched = dead | was_sampled
    opt_states = map_opt_states(
        opt_states, cap,
        lambda x: torch.where(_row_mask(touched, x), torch.zeros_like(x), x))
    return params, opt_states


def inject_noise_to_position(params: Params, noise: torch.Tensor, lr: float,
                             scaler: float = 5e5,
                             min_opacity: float = 0.005) -> Params:
    """MCMC exploration noise: means += covar @ (noise * gate * lr * scaler)
    for ``noise`` standard normal [cap, 3], where the gate
    sigmoid(100 * ((1 - op) - 0.995)) opens only for near-transparent
    Gaussians; dead slots (op <= min_opacity) stay put."""
    op = torch.sigmoid(params["opacities"])
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    covars = quat_scale_to_covar(params["quats"], torch.exp(params["scales"]))
    noise = noise * gate[:, None] * (lr * scaler)
    shaped = torch.einsum("nij,nj->ni", covars, noise)
    alive = op > min_opacity
    out = dict(params)
    out["means"] = params["means"] + torch.where(
        alive[:, None], shaped, torch.zeros_like(shaped))
    return out
