"""Mixed precision: dtype policy + functional dynamic loss scaling.

Port of ``pytorch_distributed_tpu/amp``. The scaler is a functional state
machine (scale, unscale, finite check, growth/backoff) whose skip-on-inf is
a device-side ``torch.where``: no ``.item()`` and no host sync in the step.
"""

from pytorch_distributed_tpu_torch.amp.grad_scaler import (
    GradScaler,
    GradScalerState,
)
from pytorch_distributed_tpu_torch.amp.policy import Policy, get_policy

__all__ = ["Policy", "get_policy", "GradScaler", "GradScalerState"]
