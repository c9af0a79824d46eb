"""Process groups of the port, over ``torch.distributed``.

Port of ``pytorch_distributed_tpu/distributed/__init__.py``: world state,
``init_process_group`` / ``destroy_process_group``, the eager process-group
API of ``process_group.py`` (every collective as a module function, the
object collectives, ``new_group``, ``shrink_group``), ``batch_ops.py``
(``batch_isend_irecv``, the coalescing manager), the backend registry
(``register_backend``), and the stores (``store.py``: TCP, Hash, File,
Prefix) and ``init_method`` rendezvous (``rendezvous.py``) that the
elastic launcher and checkpoints use.

The transport is c10d's: NCCL when the group runs on the card (the
default), gloo when the caller asks for the CPU. There is no fallback from
one to the other: a group that cannot come up raises. The reference's
backend names map onto them: ``"xla"`` (its device-path backend) is NCCL,
``"native"`` and ``"store"`` (its host transports) are gloo, ``"fake"`` is
:class:`FakeBackend`'s identity group, and ``"nccl"`` and ``"gloo"`` are
themselves; a third party's ``register_backend(name, creator)`` gives
``creator(store, rank, world_size, timeout) -> Backend``. The reference's
``bootstrap.py`` (``initialize_jax_distributed``, JAX's runtime start-up)
has no counterpart: ``init_process_group`` is the port's whole start-up.

``TORCH_DISTRIBUTED_DEBUG=DETAIL`` (the reference reads
``TPU_DISTRIBUTED_DEBUG``) makes every group a
:class:`ProcessGroupWrapper`, which checks each collective's op, shape
and dtype across the ranks through the store before it runs.

An NCCL group is made with ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` unless
the caller set the variable: the pipelined executor captures a sharded
step's collectives in a CUDA graph, and c10d's asynchronous error handling
must not query the events of a capture (the torch CUDA-graphs notes ask
the same of whole-network DDP capture).

Typical use, one process per rank::

    pg = init_process_group(init_method="tcp://localhost:29500", rank=r,
                            world_size=n)         # NCCL, card r % n_cards
    mesh = init_device_mesh((n,), ("cp",))
    all_reduce(torch.ones(4, device="cuda"))      # the eager API
    ...
    destroy_process_group()
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.distributed.batch_ops import (
    CoalescingManager,
    P2POp,
    as_process_group,
    batch_isend_irecv,
    coalescing_manager,
)
from pytorch_distributed_tpu_torch.distributed.process_group import (
    Backend,
    C10dBackend,
    FakeBackend,
    ProcessGroup,
    ProcessGroupWrapper,
    ReduceOp,
    Work,
)
from pytorch_distributed_tpu_torch.distributed.rendezvous import (
    register_rendezvous_handler,
    rendezvous,
)
from pytorch_distributed_tpu_torch.distributed.store import (
    DEFAULT_TIMEOUT,
    FileStore,
    HashStore,
    PrefixStore,
    Store,
    StoreTimeoutError,
    TCPStore,
)
from pytorch_distributed_tpu_torch.observability import DebugLevel, debug_level

__all__ = [
    # stores and rendezvous
    "Store", "TCPStore", "HashStore", "FileStore", "PrefixStore",
    "StoreTimeoutError", "rendezvous", "register_rendezvous_handler",
    # process-group types
    "Backend", "C10dBackend", "FakeBackend", "ProcessGroup",
    "ProcessGroupWrapper", "ReduceOp", "Work",
    # the API
    "init_process_group", "destroy_process_group", "is_initialized",
    "get_rank", "get_world_size", "get_device", "new_group",
    "get_default_group", "shrink_group", "register_backend",
    "P2POp", "batch_isend_irecv", "coalescing_manager", "CoalescingManager",
    "as_process_group",
    "all_reduce", "broadcast", "reduce", "all_gather", "gather", "scatter",
    "reduce_scatter", "all_to_all", "send", "recv", "isend", "irecv",
    "barrier", "all_gather_object", "broadcast_object", "gather_object",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

#: backend name -> the c10d backend that runs it (a string), or a creator
#: ``(store, rank, world_size, timeout) -> Backend``
_backend_registry: Dict[str, Union[str, Callable]] = {
    "nccl": "nccl", "xla": "nccl",
    "gloo": "gloo", "native": "gloo", "store": "gloo",
}


def register_backend(name: str, creator: Callable) -> None:
    """Register ``creator(store, rank, world_size, timeout) -> Backend``
    under ``name`` for :func:`init_process_group` (torch
    ``Backend.register_backend``)."""
    key = name.lower()
    if key in _backend_registry:
        raise ValueError(f"backend {name!r} already registered")
    _backend_registry[key] = creator


register_backend("fake", lambda store, rank, ws, timeout:
                 FakeBackend(store, rank, ws))


class _World:
    def __init__(self):
        self.default_pg: Optional[ProcessGroup] = None
        self.default_backend: Optional[str] = None
        self.store: Optional[dist.Store] = None
        self.owns_store: Optional[Store] = None
        self.device: Optional[torch.device] = None
        self.groups: Dict[str, ProcessGroup] = {}
        self.group_count = 0
        self.shrink_count = 0
        self.lock = threading.RLock()


_world = _World()


def _debug_detail() -> bool:
    return debug_level() is DebugLevel.DETAIL


def _make_pg(impl: Backend, name: str, store: dist.Store,
             timeout: timedelta) -> ProcessGroup:
    if _debug_detail():
        pg = ProcessGroupWrapper(impl, name, store=store,
                                 device=_world.device, timeout=timeout)
    else:
        pg = ProcessGroup(impl, name, store=store, device=_world.device)
    _world.groups[name] = pg
    return pg


def init_process_group(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    *,
    rank: int = -1,
    world_size: int = -1,
    store: Optional[Union[Store, dist.Store]] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout: timedelta = timedelta(minutes=5),
    group_name: str = "default",
) -> ProcessGroup:
    """Create the default process group (torch ``init_process_group``) and
    return it as the port's :class:`ProcessGroup`.

    ``device=None`` is the card: rank ``r`` binds card ``r % device_count``
    and the backend is NCCL. ``device="cpu"`` picks gloo. An explicit
    ``backend`` (a name of the registry) must be the one the device takes,
    with one exception: gloo on the card (``"gloo"``, ``"native"`` or
    ``"store"``), for ranks that share one card (NCCL will not put two
    ranks on one GPU; gloo stages card tensors through host memory itself,
    for the collectives it supports there). ``"fake"`` and registered
    backends make no c10d group. Give either ``init_method``
    (``tcp://host:port``, ``file://path``, or ``env://``) or ``store``,
    with ``rank`` and ``world_size``.
    """
    with _world.lock:
        if is_initialized():
            raise RuntimeError(
                "the default process group is already initialized")
        key = backend.lower() if backend is not None else None
        if key is not None and key not in _backend_registry:
            raise ValueError(f"unknown backend {backend!r} (registered: "
                             f"{sorted(_backend_registry)})")
        creator = _backend_registry.get(key)
        if callable(creator):
            return _init_registered(key, creator, init_method, rank,
                                    world_size, store, device, timeout,
                                    group_name)
        device = resolve_device(device)
        want = _BACKENDS.get(device.type)
        if want is None:
            raise ValueError(f"no process-group backend for device {device}")
        if creator is not None and creator != want:
            if (device.type, creator) != ("cuda", "gloo"):
                raise ValueError(
                    f"backend {backend!r} on a {device.type} group: the "
                    f"port runs {want} there")
            want = "gloo"
        if device.type == "cuda":
            if device.index is None:
                device = torch.device(
                    "cuda", max(rank, 0) % torch.cuda.device_count())
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
        _world.device = device
        _world.default_backend = key or want
        _world.store = dist.distributed_c10d._get_default_store()
        _world.default_pg = _make_pg(
            C10dBackend(dist.group.WORLD), group_name,
            dist.PrefixStore(f"pg:{group_name}", _world.store), timeout)
        return _world.default_pg


def _init_registered(key, creator, init_method, rank, world_size, store,
                     device, timeout, group_name) -> ProcessGroup:
    """A default group of a registered (non-c10d) backend: the fake group,
    or a third party's."""
    owned = None
    if store is None:
        store, rank, world_size = rendezvous(init_method or "env://", rank,
                                             world_size, timeout)
        owned = store
    elif rank < 0 or world_size < 0:
        raise ValueError("explicit store requires rank and world_size")
    c10d_store = store.as_c10d() if isinstance(store, Store) else store
    pg_store = dist.PrefixStore(f"pg:{group_name}", c10d_store)
    _world.device = torch.device(device) if device is not None else None
    impl = creator(pg_store, rank, world_size, timeout)
    _world.default_backend = key
    _world.store = c10d_store
    _world.owns_store = owned
    _world.default_pg = _make_pg(impl, group_name, pg_store, timeout)
    return _world.default_pg


def is_initialized() -> bool:
    return _world.default_pg is not None or dist.is_initialized()


def get_default_group() -> ProcessGroup:
    """The default group as the port's :class:`ProcessGroup` (one made over
    c10d's default group if that was initialized by torch directly)."""
    if _world.default_pg is None:
        if not dist.is_initialized():
            raise RuntimeError("default process group not initialized; "
                               "call init_process_group")
        return as_process_group(dist.group.WORLD)
    return _world.default_pg


def _pg(group) -> ProcessGroup:
    return get_default_group() if group is None else as_process_group(group)


def get_rank(group=None) -> int:
    if isinstance(group, ProcessGroup) or (group is None
                                           and _world.default_pg is not None):
        return _pg(group).rank
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    if isinstance(group, ProcessGroup) or (group is None
                                           and _world.default_pg is not None):
        return _pg(group).world_size
    return dist.get_world_size(group)


def get_device() -> torch.device:
    """The device the default group runs on (its card, or the CPU)."""
    if _world.device is None or not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group first")
    return _world.device


def new_group(ranks: Optional[List[int]] = None, *,
              backend: Optional[str] = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Optional[ProcessGroup]:
    """A subgroup over ``ranks`` (torch ``new_group``). Every rank of the
    default group calls this with the same arguments; the ranks outside
    the subgroup get None. The subgroup takes the default group's backend
    unless ``backend`` names another."""
    default = get_default_group()
    with _world.lock:
        _world.group_count += 1
        name = f"group{_world.group_count}"
    ranks = (list(ranks) if ranks is not None
             else list(range(default.world_size)))
    key = (backend or _world.default_backend or "gloo").lower()
    if key not in _backend_registry:
        raise ValueError(f"unknown backend {backend!r}")
    creator = _backend_registry[key]
    pg_store = dist.PrefixStore(f"pg:{name}", _world.store)
    if callable(creator):
        if default.rank not in ranks:
            return None
        impl = creator(pg_store, ranks.index(default.rank), len(ranks),
                       timeout)
    else:
        group = dist.new_group(ranks, timeout=timeout, backend=creator)
        if default.rank not in ranks:
            return None
        impl = C10dBackend(group)
    with _world.lock:
        return _make_pg(impl, name, pg_store, timeout)


def _c10d_backend(name: str, store, rank: int, size: int,
                  timeout: timedelta):
    """A c10d backend object of ``size`` ranks over ``store``, made without
    the other ranks of the default group."""
    if name == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, timeout)


def shrink_group(exclude_ranks: List[int], *,
                 timeout: timedelta = DEFAULT_TIMEOUT) -> ProcessGroup:
    """A smaller group without dead ranks, without a restart (torch
    ``shrink_group``). Every surviving rank of the default group calls it
    with the same ``exclude_ranks``; the excluded ranks are presumed dead
    and take no part. The survivors get a fresh group (new contiguous ranks
    in old-rank order) over a fresh store namespace, built from the store
    directly (c10d's ``new_group`` needs every rank). The default group is
    left as it is."""
    default = get_default_group()
    exclude = set(exclude_ranks)
    if default.rank in exclude:
        raise ValueError(
            f"rank {default.rank} cannot shrink itself out of the group")
    if not exclude:
        raise ValueError("exclude_ranks is empty")
    bad = [r for r in exclude if not 0 <= r < default.world_size]
    if bad:
        raise ValueError(f"exclude_ranks {bad} not in the default group "
                         f"(world size {default.world_size})")
    survivors = [r for r in range(default.world_size) if r not in exclude]
    new_rank = survivors.index(default.rank)
    with _world.lock:
        _world.shrink_count += 1
        name = (f"shrink{_world.shrink_count}:"
                + ",".join(map(str, sorted(exclude))))
    pg_store = dist.PrefixStore(f"pg:{name}", _world.store)
    creator = _backend_registry[_world.default_backend]
    if callable(creator):
        impl = creator(pg_store, new_rank, len(survivors), timeout)
    else:
        impl = C10dBackend(_c10d_backend(creator, pg_store, new_rank,
                                         len(survivors), timeout))
    with _world.lock:
        return _make_pg(impl, name, pg_store, timeout)


def destroy_process_group() -> None:
    """Tear down the default group and every group made from it."""
    with _world.lock:
        for pg in _world.groups.values():
            pg.shutdown()
        _world.groups.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        if _world.owns_store is not None and hasattr(_world.owns_store,
                                                     "close"):
            _world.owns_store.close()
        _world.default_pg = None
        _world.default_backend = None
        _world.store = None
        _world.owns_store = None
        _world.device = None


# -- module-level collectives (the default group unless ``group``) ---------
def _run(work: Work, async_op: bool):
    return work if async_op else work.result()


def all_reduce(t, op: ReduceOp = ReduceOp.SUM, group=None, async_op=False):
    return _run(_pg(group).all_reduce(t, op, async_op=async_op), async_op)


def broadcast(t, src: int = 0, group=None, async_op=False):
    return _run(_pg(group).broadcast(t, src, async_op=async_op), async_op)


def reduce(t, dst: int, op: ReduceOp = ReduceOp.SUM, group=None,
           async_op=False):
    return _run(_pg(group).reduce(t, dst, op, async_op=async_op), async_op)


def all_gather(t, group=None, async_op=False):
    return _run(_pg(group).all_gather(t, async_op=async_op), async_op)


def gather(t, dst: int = 0, group=None, async_op=False):
    return _run(_pg(group).gather(t, dst, async_op=async_op), async_op)


def scatter(tensors, src: int = 0, group=None, async_op=False, *, out=None):
    return _run(_pg(group).scatter(tensors, src, out=out, async_op=async_op),
                async_op)


def reduce_scatter(t, op: ReduceOp = ReduceOp.SUM, group=None,
                   async_op=False):
    return _run(_pg(group).reduce_scatter(t, op, async_op=async_op),
                async_op)


def all_to_all(tensors, group=None, async_op=False):
    return _run(_pg(group).all_to_all(tensors, async_op=async_op), async_op)


def send(t, dst: int, tag: int = 0, group=None) -> None:
    _pg(group).send(t, dst, tag)


def recv(out, src: int, tag: int = 0, group=None):
    return _pg(group).recv(out, src, tag)


def isend(t, dst: int, tag: int = 0, group=None) -> Work:
    return _pg(group).isend(t, dst, tag)


def irecv(out, src: int, tag: int = 0, group=None) -> Work:
    return _pg(group).irecv(out, src, tag)


def barrier(group=None, async_op=False):
    return _run(_pg(group).barrier(async_op=async_op), async_op)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    return _pg(group).all_gather_object(obj)


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    return _pg(group).broadcast_object(obj, src)


def gather_object(obj: Any, dst: int = 0, group=None):
    return _pg(group).gather_object(obj, dst)
