"""Process groups of the port, over ``torch.distributed``.

Port of the part of ``pytorch_distributed_tpu/distributed/__init__.py``
that the port's training runs on: the default process group, its rank and
size, and its teardown, and the stores (``store.py``: TCP, Hash, File,
Prefix) and ``init_method`` rendezvous (``rendezvous.py``) that the
elastic launcher and checkpoints use. The backend follows the port's
device: NCCL when the group runs on the card (the default), gloo when the
caller asks for the CPU. There is no fallback from one to the other: a
group that cannot come up raises. ``process_group.py``, ``batch_ops.py``,
the bootstrap and the reference's backends are ROADMAP A.12.

An NCCL group is made with ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` unless
the caller set the variable: the pipelined executor captures a sharded
step's collectives in a CUDA graph, and c10d's asynchronous error handling
must not query the events of a capture (the torch CUDA-graphs notes ask
the same of whole-network DDP capture).

Typical use, one process per rank::

    init_process_group(init_method="tcp://localhost:29500", rank=r,
                       world_size=n)              # NCCL, card r % n_cards
    mesh = init_device_mesh((n,), ("cp",))
    ...
    destroy_process_group()
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.distributed.rendezvous import (
    register_rendezvous_handler,
    rendezvous,
)
from pytorch_distributed_tpu_torch.distributed.store import (
    FileStore,
    HashStore,
    PrefixStore,
    Store,
    StoreTimeoutError,
    TCPStore,
)

__all__ = [
    "init_process_group",
    "get_rank",
    "get_world_size",
    "get_device",
    "destroy_process_group",
    "Store",
    "TCPStore",
    "HashStore",
    "FileStore",
    "PrefixStore",
    "StoreTimeoutError",
    "rendezvous",
    "register_rendezvous_handler",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_group_device: Optional[torch.device] = None


def init_process_group(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    *,
    rank: int = -1,
    world_size: int = -1,
    store: Optional[Union[Store, dist.Store]] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout: timedelta = timedelta(minutes=5),
) -> None:
    """Create the default process group (torch ``init_process_group``).

    ``device=None`` is the card: rank ``r`` binds card ``r % device_count``
    and the backend is NCCL. ``device="cpu"`` picks gloo. An explicit
    ``backend`` must be the one the device takes, with one exception:
    ``backend="gloo"`` on the card, for ranks that share one card (NCCL
    will not put two ranks on one GPU; gloo stages card tensors through
    host memory itself, for the collectives it supports there). Give either
    ``init_method`` (``tcp://host:port``, ``file://path``, or ``env://``)
    or ``store``, with ``rank`` and ``world_size``.
    """
    global _group_device
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialized")
    device = resolve_device(device)
    want = _BACKENDS.get(device.type)
    if want is None:
        raise ValueError(f"no process-group backend for device {device}")
    if backend is not None and backend.lower() != want:
        if (device.type, backend.lower()) != ("cuda", "gloo"):
            raise ValueError(
                f"backend {backend!r} on a {device.type} group: the port "
                f"runs {want} there"
            )
        want = "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", max(rank, 0) % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if want == "nccl":
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if isinstance(store, Store):
        store = store.as_c10d()
    dist.init_process_group(
        backend=want, init_method=init_method, store=store, rank=rank,
        world_size=world_size, timeout=timeout,
        device_id=device if want == "nccl" else None,
    )
    _group_device = device


def get_rank(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_rank(group)


def get_world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_world_size(group)


def get_device() -> torch.device:
    """The device the default group runs on (its card, or the CPU)."""
    if _group_device is None or not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group first")
    return _group_device


def destroy_process_group() -> None:
    """Tear down the default group and every group made from it."""
    global _group_device
    dist.destroy_process_group()
    _group_device = None
