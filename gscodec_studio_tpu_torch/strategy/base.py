"""Strategy interface (port of gscodec_studio_tpu/strategy/base.py).

A strategy is a dataclass of hyperparameters with methods that return new
state instead of editing it:

  initialize_state(cap, scene_scale, device) -> state dict
  update_state(state, info, v_means2d) -> state               (every step)
  refine(params, opt_states, state, step, generator)
      -> (params, opt_states, state)                          (static caps)

The trainer decides when to call refine (every ``refine_every`` steps
inside the configured window).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Strategy:
    def initialize_state(self, cap: int, scene_scale: float, device=None):
        raise NotImplementedError

    def update_state(self, state, info, v_means2d):
        raise NotImplementedError

    def refine(self, params, opt_states, state, step, generator=None):
        raise NotImplementedError
