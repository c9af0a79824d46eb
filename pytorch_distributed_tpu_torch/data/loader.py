"""Batches for the training entry points: ``torch.utils.data.DataLoader``
over the port's ``DistributedSampler``, and a device prefetcher.

The part of ``pytorch_distributed_tpu/data/loader.py`` that the entry
points need. Torch's ``DataLoader`` plays the part of the JAX package's
own worker-pool loader, with pinned host memory on the card.
:func:`prefetch_to_device` is the counterpart of ``prefetch_to_mesh``
(``loader.py:278``): while the step runs on batch ``n``, the copies of the
next ``depth`` batches are already queued on a side stream.
:func:`pad_batch` is the reference's uneven-final-batch padding.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader

from pytorch_distributed_tpu_torch.observability import annotate

__all__ = ["make_loader", "pad_batch", "prefetch_to_device"]


def pad_batch(batch, to_size: int):
    """A (tuple of) numpy array(s) padded along dim 0 to ``to_size``, as
    ``(*padded, mask)`` with a 0/1 fp32 validity mask: the uneven final
    batch (torch ``Join``'s role). Every rank steps with a full-shape batch
    and the mask-aware losses (``trainer.classification_loss``,
    ``lm_loss``) leave the padded rows out of the loss and the gradients.
    The padding repeats the last row; a rank with no rows at all (``n ==
    0``) pads with zeros under an all-zero mask."""
    arrays = batch if isinstance(batch, tuple) else (batch,)
    n = arrays[0].shape[0]
    if n > to_size:
        raise ValueError(f"batch ({n}) larger than pad target ({to_size})")
    pad = to_size - n
    padded = tuple(
        np.concatenate([a, np.repeat(a[-1:], pad, axis=0) if n
                        else np.zeros((pad,) + a.shape[1:], a.dtype)])
        if pad else a
        for a in arrays)
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (*padded, mask)


def make_loader(dataset, batch_size: int, sampler, *, device: torch.device,
                num_workers: int = 0, prefetch_factor: int = 2,
                mp_context: str = "fork") -> DataLoader:
    """A ``DataLoader`` over ``sampler`` (the port's ``DistributedSampler``)
    that collates ``batch_size`` examples a batch (the last partial batch
    dropped), in ``num_workers``
    worker processes (``mp_context`` start method, ``prefetch_factor``
    batches ahead each), into pinned host memory when ``device`` is the
    card."""
    workers = dict(num_workers=num_workers)
    if num_workers:
        workers.update(prefetch_factor=prefetch_factor,
                       multiprocessing_context=mp_context)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      drop_last=True, pin_memory=device.type == "cuda",
                      **workers)


def _to(batch, device, non_blocking):
    return tuple(x.to(device, non_blocking=non_blocking) for x in batch)


def prefetch_to_device(loader: Iterable, device: torch.device,
                       depth: int = 2) -> Iterator[tuple]:
    """Yield ``loader``'s batches (tuples of tensors) on ``device``, with
    the copies of up to ``depth`` batches started ahead.

    On the card each batch is copied with ``non_blocking`` on a side
    stream, and an event recorded after its copies; the consumer's stream
    waits on that event before the batch is handed over, and the tensors
    are marked as used on the consumer's stream so that their memory is
    not reused while its work is queued. The copies overlap the step only
    from pinned host memory (``make_loader`` pins on the card). On the CPU
    the batches pass through as they are. The wait for the loader's next
    batch is the host region ``data.wait`` (``observability.annotate``).
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    source = iter(loader)

    def wait():
        with annotate("data.wait"):
            return next(source, None)

    if device.type != "cuda":
        while (batch := wait()) is not None:
            yield _to(batch, device, False)
        return
    side = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def enqueue() -> bool:
        batch = wait()
        if batch is None:
            return False
        with torch.cuda.stream(side):
            placed = _to(batch, device, True)
            done = torch.cuda.Event()
            done.record(side)
        queue.append((placed, done))
        return True

    while len(queue) < depth and enqueue():
        pass
    while queue:
        placed, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for x in placed:
            x.record_stream(consumer)
        enqueue()
        yield placed
