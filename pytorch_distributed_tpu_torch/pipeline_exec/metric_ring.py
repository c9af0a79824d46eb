"""On-device metric ring buffer.

Port of ``pytorch_distributed_tpu/pipeline_exec/metric_ring.py``. The
per-step metric scalars (loss, grad_norm, accuracy, ...) never leave the
device on the hot path: the step writes them into a fixed-size ring, and
the host drains whole windows with non-blocking copies. The JAX ring is a
pytree threaded through the donated step; this one is a pair of tensors
updated in place, so a captured step writes the same buffers at every
replay.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["MetricRing"]


class MetricRing:
    """Fixed-size ring of per-step scalar metrics, resident on the device.

    Fields:
      idx: total steps pushed so far (int32 scalar); the write slot of the
        next push is ``idx % size``.
      buf: ``[n_metrics, size]`` fp32, one row per metric in sorted-name
        order.
    """

    def __init__(self, names: Sequence[str], idx: torch.Tensor,
                 buf: torch.Tensor):
        self.names = tuple(names)
        self.idx = idx
        self.buf = buf

    @property
    def size(self) -> int:
        return self.buf.shape[1]

    @classmethod
    def create(cls, names: Sequence[str], size: int,
               device=None) -> "MetricRing":
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        if not names:
            raise ValueError("metric ring needs at least one metric name")
        names = tuple(sorted(names))
        return cls(names, torch.zeros((), dtype=torch.int32, device=device),
                   torch.zeros((len(names), size), dtype=torch.float32,
                               device=device))

    def push(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Write one step's metrics at the current slot, in place, with no
        read back to the host. Bools (``all_finite``) are stored as
        0.0/1.0."""
        slot = torch.remainder(self.idx, self.size).long().reshape(1)
        row = torch.stack([metrics[k].detach().float().reshape(())
                           for k in self.names])
        self.buf.index_copy_(1, slot, row[:, None])
        self.idx += 1

    def reset(self) -> None:
        """Empty the ring in place (its buffers keep their addresses)."""
        self.idx.zero_()
        self.buf.zero_()

    def stacked(self) -> torch.Tensor:
        """``[n_metrics, size]`` snapshot in sorted-name order: a fresh
        tensor, never the ring's own buffer."""
        return self.buf.clone()
