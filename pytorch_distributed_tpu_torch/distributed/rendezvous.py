"""``init_method`` rendezvous: a registry of URL-scheme handlers.

Port of ``pytorch_distributed_tpu/distributed/rendezvous.py`` (torch
``distributed/rendezvous.py``): resolve ``env://``, ``tcp://host:port`` and
``file:///path`` to ``(store, rank, world_size)`` over the port's stores;
:func:`register_rendezvous_handler` adds a scheme. ``rank`` and
``world_size`` come from the arguments, else from the URL's query
(``?rank=0&world_size=2``), else from ``RANK``/``WORLD_SIZE``; ``env://``
reads ``MASTER_ADDR``/``MASTER_PORT``. Rank 0 hosts a TCP store.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from pytorch_distributed_tpu_torch.distributed.store import (
    DEFAULT_TIMEOUT,
    FileStore,
    Store,
    TCPStore,
)

__all__ = ["rendezvous", "register_rendezvous_handler"]

_handlers: Dict[str, Callable] = {}


def register_rendezvous_handler(scheme: str, handler: Callable) -> None:
    """Register ``handler(url, rank, world_size, timeout) -> (store, rank,
    world_size)`` for a URL scheme. A second registration raises."""
    if scheme in _handlers:
        raise ValueError(f"rendezvous scheme {scheme!r} already registered")
    _handlers[scheme] = handler


def _env_int(name: str, override: Optional[str]) -> int:
    val = override if override is not None else os.environ.get(name)
    if val is None:
        raise ValueError(
            f"rendezvous: {name} must be set (env var or URL query arg)")
    return int(val)


def _rank_and_size(url, rank: int, world_size: int) -> Tuple[int, int]:
    q = {k: v[-1] for k, v in parse_qs(url.query).items()}
    if rank < 0:
        rank = _env_int("RANK", q.get("rank"))
    if world_size < 0:
        world_size = _env_int("WORLD_SIZE", q.get("world_size"))
    return rank, world_size


def _tcp_handler(url, rank, world_size, timeout):
    rank, world_size = _rank_and_size(url, rank, world_size)
    host, port = url.hostname, url.port
    if not host or not port:
        raise ValueError(f"tcp:// rendezvous needs host:port, got {url.geturl()}")
    store = TCPStore(host, port, world_size, is_master=(rank == 0),
                     timeout=timeout)
    return store, rank, world_size


def _env_handler(url, rank, world_size, timeout):
    rank, world_size = _rank_and_size(url, rank, world_size)
    store = TCPStore(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                     int(os.environ.get("MASTER_PORT", "29500")), world_size,
                     is_master=(rank == 0), timeout=timeout)
    return store, rank, world_size


def _file_handler(url, rank, world_size, timeout):
    rank, world_size = _rank_and_size(url, rank, world_size)
    if not url.path:
        raise ValueError(f"file:// rendezvous needs a path, got {url.geturl()}")
    return FileStore(url.path, world_size, timeout=timeout), rank, world_size


register_rendezvous_handler("tcp", _tcp_handler)
register_rendezvous_handler("env", _env_handler)
register_rendezvous_handler("file", _file_handler)


def rendezvous(
    url: str,
    rank: int = -1,
    world_size: int = -1,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Tuple[Store, int, int]:
    """Resolve an ``init_method`` URL to ``(store, rank, world_size)``."""
    parsed = urlparse(url)
    scheme = parsed.scheme or "env"
    if scheme not in _handlers:
        raise ValueError(f"no rendezvous handler for scheme {scheme!r} "
                         f"(registered: {sorted(_handlers)})")
    return _handlers[scheme](parsed, rank, world_size, timeout)
