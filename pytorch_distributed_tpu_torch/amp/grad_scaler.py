"""Dynamic loss scaling: a functional GradScaler.

Port of ``pytorch_distributed_tpu/amp/grad_scaler.py``, with torch's
``amp.GradScaler`` constants: init scale 2**16, growth 2.0, backoff 0.5,
interval 2000. Scale the loss by ``scale``; unscale the grads; if any grad
is non-finite the step is skipped and the scale is multiplied by
``backoff_factor``; after ``growth_interval`` consecutive finite steps it is
multiplied by ``growth_factor``.

The state is two 0-d tensors on the device, and every decision is a
``torch.where`` on them: nothing is read back to the host inside a step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

__all__ = ["GradScaler", "GradScalerState"]


@dataclasses.dataclass(frozen=True)
class GradScalerState:
    scale: torch.Tensor           # f32 scalar
    growth_tracker: torch.Tensor  # i32 consecutive-finite counter


@dataclasses.dataclass(frozen=True)
class GradScaler:
    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True

    def init(self, device=None) -> GradScalerState:
        return GradScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def scale(self, loss: torch.Tensor, state: GradScalerState) -> torch.Tensor:
        if not self.enabled:
            return loss
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads: Sequence[torch.Tensor], state: GradScalerState
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Unscaled fp32 grads and ``all_finite`` (a 0-d bool tensor)."""
        if not self.enabled:
            return list(grads), torch.ones((), dtype=torch.bool,
                                           device=state.scale.device)
        inv = 1.0 / state.scale
        grads = [g.float() * inv for g in grads]
        if not grads:
            return grads, torch.ones((), dtype=torch.bool,
                                     device=state.scale.device)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        return grads, finite

    def update(self, state: GradScalerState, all_finite: torch.Tensor
               ) -> GradScalerState:
        if not self.enabled:
            return state
        grew = state.growth_tracker + 1 >= self.growth_interval
        new_scale = torch.where(
            all_finite,
            torch.where(grew, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor,
        )
        new_tracker = torch.where(
            all_finite,
            torch.where(grew, torch.zeros_like(state.growth_tracker),
                        state.growth_tracker + 1),
            torch.zeros_like(state.growth_tracker),
        )
        return GradScalerState(scale=new_scale.float(),
                               growth_tracker=new_tracker.int())
