"""Train state: what the step carries besides the model and optimizer.

Port of ``pytorch_distributed_tpu/parallel/state.py``. In JAX the whole
state (params, optimizer state, scaler) is one pytree threaded through the
jitted step. In torch the parameters live in the model and the optimizer
state in the optimizer, both updated in place by ``Trainer.step``, so the
state object keeps the rest: the step count, the loss-scaler state and a
communication-hook state (``None``: hooks are ROADMAP A.14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from pytorch_distributed_tpu_torch.amp.grad_scaler import GradScalerState

__all__ = ["TrainState"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int = 0
    scaler: Optional[GradScalerState] = None
    comm_state: Optional[Any] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
