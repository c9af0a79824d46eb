"""Placement strategies.

Port of ``pytorch_distributed_tpu/parallel/strategies.py``, ``NoShard``
only: the whole model, its gradients and its optimizer state sit on one
device (the "mesh" is that one card), and the batch is not split. The
strategies that shard (DataParallel, FSDP, ZeRO1, hybrid) come with
ROADMAP A.4 and A.11.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device

__all__ = ["ShardingStrategy", "NoShard"]


def _to_device(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device, non_blocking=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(t, device) for t in x)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return x


class ShardingStrategy:
    """Base: everything on one device, batch not split."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def place_batch(self, batch):
        """Host batch (numpy arrays or tensors, nested in tuples) on the
        strategy's device."""
        return _to_device(batch, self.device)


class NoShard(ShardingStrategy):
    """Single-device, fully replicated strategy (torch
    ``ShardingStrategy.NO_SHARD``)."""
