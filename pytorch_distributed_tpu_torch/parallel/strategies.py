"""Placement strategies.

Port of ``pytorch_distributed_tpu/parallel/strategies.py``:

* ``NoShard``: the whole model, its gradients and its optimizer state on
  one device, the batch not split;
* ``DataParallel(mesh, dp_axis)``: one replica per rank of ``dp_axis``;
  each rank takes its share of every microbatch of the global batch, its
  BatchNorm layers take their statistics over the axis's process group
  (the global batch, as the JAX package's global-view step has them), and
  after the backward the gradients are averaged over the group (one
  all-reduce of one flat buffer), so the trainer steps on the global mean
  gradient, as the JAX step does;
* ``CPStrategy(mesh, cp_axis)``: ``DataParallel`` over the context-parallel
  axis with the batch replicated: the sequence is split inside the
  attention (``parallel.context_parallel``), not here.

The strategies that shard parameters (FSDP, ZeRO1, hybrid) are ROADMAP
A.11; gradient communication hooks are A.14.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.data.sharding import LocalBatch

__all__ = ["ShardingStrategy", "NoShard", "DataParallel", "CPStrategy"]


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

    def place_batch(self, batch, accum: int = 1):
        """Host batch (numpy arrays or tensors, nested in tuples) on the
        strategy's device; ``accum`` is the trainer's microbatch count."""
        return _to_device(batch, self.device)

    def sync_params(self, model: torch.nn.Module) -> None:
        """Make every replica hold the same parameters (one replica: no-op)."""

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients the optimizer steps on (one replica: as they are)."""
        return grads


class NoShard(ShardingStrategy):
    """Single-device, fully replicated strategy (torch
    ``ShardingStrategy.NO_SHARD``)."""


class DataParallel(ShardingStrategy):
    """DDP semantics over ``mesh``'s ``dp_axis``: replicated parameters,
    the batch split along dim 0 by the rank's coordinate on the axis, and
    the gradients averaged over the axis's group after the backward."""

    def __init__(self, mesh, dp_axis: str = "dp"):
        if dp_axis not in mesh.axis_names:
            raise ValueError(f"axis {dp_axis!r} not in mesh {mesh.axis_names}")
        super().__init__(mesh.device)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.batch_axes = dp_axis
        self.group = mesh.get_group(dp_axis)

    @property
    def data_shard_count(self) -> int:
        """Number of data shards (the 'world size' for the sampler)."""
        return 1 if self.batch_axes is None else self.mesh.size(self.batch_axes)

    def place_batch(self, batch, accum: int = 1):
        """This rank's rows of the global batch, in microbatch order: the
        global batch splits into ``accum`` microbatches of consecutive rows
        (the JAX step's reshape), each microbatch into ``data_shard_count``
        equal shares, and the rank's shares are stacked, so that cutting
        its rows into ``accum`` equal parts gives its share of each
        microbatch. At ``accum = 1`` this is the ``rank``-th of
        ``data_shard_count`` equal slices. A :class:`LocalBatch` (this
        rank's own rows, from a per-process loader) is placed as it is."""
        if isinstance(batch, LocalBatch):
            return LocalBatch(super().place_batch(tuple(batch)))
        batch = super().place_batch(batch)
        n = self.data_shard_count
        if n == 1:
            return batch
        i = self.mesh.get_local_rank(self.batch_axes)

        def shard(x):
            if isinstance(x, (tuple, list)):
                return type(x)(shard(t) for t in x)
            B = x.shape[0]
            if B % (n * accum):
                raise ValueError(f"global batch of {B} does not split into "
                                 f"{accum} microbatches of {n} equal shares")
            rows = x.reshape(accum, n, B // (n * accum), *x.shape[1:])[:, i]
            return rows.reshape(B // n, *x.shape[1:])

        return shard(batch)

    @torch.no_grad()
    def sync_params(self, model: torch.nn.Module) -> None:
        """Every replica takes the parameters and floating buffers (the
        BatchNorm running statistics) of the axis's first rank (one
        broadcast of one flat buffer per dtype), and each BatchNorm (a
        module with a ``stats_group`` attribute) takes its statistics over
        the axis's group when the batch is split over it."""
        tensors = list(model.parameters()) + [
            b for b in model.buffers() if b.is_floating_point()]
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, dist.get_global_rank(self.group, 0),
                           group=self.group)
            for t, new in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(new.view_as(t))
        stats_group = self.group if self.batch_axes is not None else None
        for m in model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = stats_group

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of every rank's gradients over the axis's group: one
        fp32 buffer, one all-reduce (sum), divided by the group size."""
        n = dist.get_world_size(self.group)
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= n
        return [new.view_as(g).to(g.dtype)
                for g, new in zip(grads, flat.split([g.numel() for g in grads]))]


class CPStrategy(DataParallel):
    """Context parallelism's placement (the JAX recipe's ``CPStrategy``):
    ``DataParallel`` over ``cp_axis`` with the batch replicated, since the
    attention splits the sequence over the axis itself. The gradients come
    out the same on every rank; the mean keeps them so."""

    def __init__(self, mesh, cp_axis: str = "cp"):
        super().__init__(mesh, cp_axis)
        self.batch_axes = None
