"""Slot-based densification primitives at a static capacity (port of
gscodec_studio_tpu/strategy/ops.py: allocate_slots, scatter_rows,
copy_to_slots, split_to_slots, remove_slots, reset_opacities).

The splat tensors keep their capacity ``cap``; dead slots are recycled.
``opt_states`` is {name: {"count", "exp_avg", "exp_avg_sq"}}
(optimizers/builders.py): every moment tensor whose leading dimension is
cap gets the same row edits as the parameters, new rows zeroed, and the
step counts stay. Each op returns new tensors and leaves its inputs as
they were.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from gscodec_studio_tpu_torch.models.splats import DEAD_OPACITY_LOGIT
from gscodec_studio_tpu_torch.ops.quat import quat_to_rotmat

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
