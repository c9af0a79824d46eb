"""Host batch -> the rank's batch on its device.

Counterpart of ``pytorch_distributed_tpu/data/sharding.py``. In the JAX
package a batch becomes one global array laid out over the mesh, either
from the whole global batch or assembled from every process's local
shard. Here each rank holds its own rows, so the function says which of
the two the caller holds: the global batch, which the strategy's
placement cuts (``DataParallel.place_batch``, in the order the microbatches
need), or this process's own shard (a :class:`LocalBatch`), which nothing
cuts again.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["LocalBatch", "shard_batch_for_mesh"]


class LocalBatch(tuple):
    """A batch that is already this rank's own rows (a per-process loader's
    shard of the global batch): strategies place it without cutting it.
    Under gradient accumulation the rank's share of microbatch ``i`` is its
    ``i``-th block of consecutive rows, so the global microbatch ``i`` is
    the ranks' ``i``-th blocks together (the JAX package assembles the
    global batch from the processes' shards in process order and cuts
    microbatches from that: the same examples in the step, grouped into
    other microbatches)."""


def _place(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def shard_batch_for_mesh(batch, mesh, batch_axes: Optional[str] = "dp", *,
                         global_batch: bool = True):
    """Place a tuple of host arrays (numpy or tensors, dim 0 the batch) on
    ``mesh.device``.

    Args:
      batch: tuple of arrays.
      mesh: the port's ``DeviceMesh``.
      batch_axes: the mesh axis the batch is split over (the strategy's
        ``dp`` axis); ``None`` replicates it, and the batch is the global
        one on every rank.
      global_batch: True if ``batch`` is the whole global batch (every rank
        holds the same one; the strategy's placement takes the rank's
        rows). False if it is this process's own shard: it comes back as a
        :class:`LocalBatch`.
    """
    placed = tuple(_place(x, mesh.device) for x in batch)
    if global_batch or batch_axes is None:
        return placed
    return LocalBatch(placed)
