"""Key-value stores of the port: TCPStore, HashStore, FileStore, PrefixStore.

Port of ``pytorch_distributed_tpu/distributed/store.py``: the c10d
``Store`` contract (``set/get/add/wait/check/compare_set/delete_key/
num_keys`` with per-call timeouts) plus the reference's ``get_nowait``
(absent is ``None``, not an exception: the multihost router and the
rendezvous poll it), ``barrier_id`` and ``ping``.

* :class:`TCPStore` wraps c10d's ``torch.distributed.TCPStore``, where the
  reference drives its own C++ engine through ctypes. Like the reference,
  it keeps a small pool of client connections, so a long blocking
  ``get``/``wait`` on one thread does not hold up the other threads of the
  process (the elastic keep-alive heartbeat): a c10d client serialises its
  calls.
* :class:`HashStore` wraps c10d's in-process ``HashStore``.
* :class:`FileStore` is the reference's directory store, kept here as the
  port's own Python copy: one file per key, atomic publish by rename,
  ``add`` under an ``fcntl`` lock. c10d's ``FileStore`` is one file whose
  lifetime is tied to a world size, which is another contract.
* :class:`PrefixStore` namespaces keys (``prefix/key``, as c10d's does).

Three differences of c10d from the reference contract are mapped here:
c10d reads a zero timeout as *no* timeout (a ``wait`` at ``timedelta(0)``,
or at anything under a millisecond, which it rounds to 0 ms, blocks for
good), so such a timeout is a non-blocking ``check``; c10d
raises ``DistStoreError`` (a ``RuntimeError``) on a timeout, mapped to
:class:`StoreTimeoutError` (a ``TimeoutError``); and c10d's ``get`` waits
on the store's own timeout, so a per-call timeout is ``wait([key], t)``
then ``get``.

:meth:`Store.as_c10d` gives the c10d store that
``distributed.init_process_group(store=...)`` passes to torch: the wrapped
one, a c10d ``PrefixStore`` over it, or (a :class:`FileStore`) an adapter
that forwards c10d's calls to the Python methods.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import Iterable, Optional, Union

import torch.distributed as dist

__all__ = [
    "Store",
    "TCPStore",
    "HashStore",
    "FileStore",
    "PrefixStore",
    "StoreTimeoutError",
]

DEFAULT_TIMEOUT = timedelta(seconds=300)


class StoreTimeoutError(TimeoutError):
    pass


def _to_bytes(v: Union[str, bytes]) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


def _resolve_timeout(timeout, default) -> timedelta:
    """An explicit zero means "do not block"; only None takes the store's
    default."""
    return default if timeout is None else timeout


class Store:
    """Abstract key-value store (c10d ``Store`` semantics)."""

    timeout: timedelta = DEFAULT_TIMEOUT

    def set(self, key: str, value: Union[str, bytes]) -> None:
        raise NotImplementedError

    def get(self, key: str, timeout: Optional[timedelta] = None) -> bytes:
        """Blocking: waits for the key up to ``timeout`` (default: the
        store's)."""
        raise NotImplementedError

    def get_nowait(self, key: str) -> Optional[bytes]:
        """The value, or ``None`` if the key is absent (pollers use this
        instead of ``get`` at a zero timeout: absent is a value)."""
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, keys: Iterable[str],
             timeout: Optional[timedelta] = None) -> None:
        raise NotImplementedError

    def check(self, keys: Iterable[str]) -> bool:
        raise NotImplementedError

    def compare_set(self, key: str, expected: Union[str, bytes],
                    desired: Union[str, bytes]) -> bytes:
        raise NotImplementedError

    def delete_key(self, key: str) -> bool:
        raise NotImplementedError

    def num_keys(self) -> int:
        raise NotImplementedError

    def barrier_id(self, name: str, rank: int, world_size: int,
                   timeout: Optional[timedelta] = None) -> None:
        """Store-based barrier (the c10d store-barrier pattern)."""
        arrived = self.add(f"{name}/arrived", 1)
        if arrived == world_size:
            self.set(f"{name}/done", b"1")
        self.wait([f"{name}/done"], timeout)

    def as_c10d(self) -> dist.Store:
        """A c10d store over this one, for ``init_process_group``."""
        return _C10dAdapter(self)


class _C10dAdapter(dist.Store):
    """c10d's calls on a Python store (c10d calls ``wait`` with and
    without a timeout, ``get`` without one)."""

    def __init__(self, store: Store):
        super().__init__()
        self._store = store

    def set(self, key, value):
        self._store.set(key, value)

    def get(self, key):
        return self._store.get(key)

    def add(self, key, amount):
        return self._store.add(key, amount)

    def wait(self, keys, timeout=None):
        self._store.wait(keys, timeout)

    def check(self, keys):
        return self._store.check(keys)

    def compare_set(self, key, expected, desired):
        return self._store.compare_set(key, expected, desired)

    def delete_key(self, key):
        return self._store.delete_key(key)

    def num_keys(self):
        return self._store.num_keys()


class _Wrapped(Store):
    """The contract over a c10d store: per-call timeouts, zero as
    non-blocking, c10d's timeout error mapped. Subclasses provide
    ``_run(fn)``, which calls ``fn`` with a c10d store to use."""

    def _run(self, fn):
        raise NotImplementedError

    def _call(self, what: str, fn, key=""):
        try:
            return self._run(fn)
        except dist.DistStoreError as e:
            raise StoreTimeoutError(f"{what} timed out (key={key!r}): {e}"
                                    ) from None

    def set(self, key, value) -> None:
        v = _to_bytes(value)
        self._call("set", lambda s: s.set(key, v), key)

    def get(self, key, timeout=None) -> bytes:
        self.wait([key], timeout)
        return self._call("get", lambda s: s.get(key), key)

    def get_nowait(self, key) -> Optional[bytes]:
        if not self.check([key]):
            return None
        return self._call("get", lambda s: s.get(key), key)

    def add(self, key, amount: int) -> int:
        return self._call("add", lambda s: s.add(key, amount), key)

    def wait(self, keys, timeout=None) -> None:
        keys = list(keys)
        t = _resolve_timeout(timeout, self.timeout)
        if t < timedelta(milliseconds=1):    # c10d's 0 ms: no timeout at all
            if not self.check(keys):
                raise StoreTimeoutError(f"wait timed out (keys={keys})")
            return
        self._call("wait", lambda s: s.wait(keys, t), ",".join(keys))

    def check(self, keys) -> bool:
        keys = list(keys)
        return self._call("check", lambda s: s.check(keys))

    def compare_set(self, key, expected, desired) -> bytes:
        e, d = _to_bytes(expected), _to_bytes(desired)
        return self._call("compare_set",
                          lambda s: s.compare_set(key, e, d), key)

    def delete_key(self, key) -> bool:
        return self._call("delete_key", lambda s: s.delete_key(key), key)

    def num_keys(self) -> int:
        return self._call("num_keys", lambda s: s.num_keys())


class TCPStore(_Wrapped):
    """Master-hosted TCP key-value store over c10d's ``TCPStore``.

    The master rank passes ``is_master=True`` and hosts the server (port 0
    binds a free port: read ``.port``); everyone, the master included,
    talks through client connections, up to ``max_connections`` of them,
    grown as concurrent calls need them. ``close`` is idempotent; later
    calls raise. A call already blocked in c10d runs on to its timeout.
    """

    def __init__(
        self,
        host_name: str,
        port: int,
        world_size: Optional[int] = None,
        is_master: bool = False,
        timeout: timedelta = DEFAULT_TIMEOUT,
        wait_for_workers: bool = False,
        max_connections: int = 4,
    ):
        self.host = host_name
        self.is_master = is_master
        self.world_size = world_size
        self.timeout = timeout
        self._store = dist.TCPStore(host_name, port, world_size, is_master,
                                    timeout, wait_for_workers=wait_for_workers)
        self.port = self._store.port
        self._closed = False
        self._pool: "queue.LifoQueue" = queue.LifoQueue()
        self._pool.put(self._store)
        self._lock = threading.Lock()
        self._n_conns = 1
        self._max_conns = max(1, max_connections)

    def _checkout(self):
        if self._closed:
            raise RuntimeError("TCPStore is closed")
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            grow = self._n_conns < self._max_conns
            if grow:
                self._n_conns += 1
        if grow:
            # the master's server listens on every interface
            host = "127.0.0.1" if self.is_master else self.host
            return dist.TCPStore(host, self.port, None, False, self.timeout,
                                 wait_for_workers=False)
        return self._pool.get()

    def _run(self, fn):
        conn = self._checkout()
        try:
            return fn(conn)
        finally:
            if not self._closed:
                self._pool.put(conn)

    def as_c10d(self) -> dist.Store:
        return self._store

    def ping(self) -> bool:
        """True while the server answers."""
        try:
            self._run(lambda s: s.check(["__ping__"]))
            return True
        except (RuntimeError, ConnectionError):
            return False

    def close(self) -> None:
        """Drop the connections (and the master's server with them)."""
        if self._closed:
            return
        self._closed = True
        while True:
            try:
                self._pool.get_nowait()
            except queue.Empty:
                break
        self._store = None


class HashStore(_Wrapped):
    """In-process store over c10d's ``HashStore`` (tests, one process)."""

    def __init__(self, timeout: timedelta = DEFAULT_TIMEOUT):
        self.timeout = timeout
        self._store = dist.HashStore()
        self._store.set_timeout(timeout)

    def _run(self, fn):
        return fn(self._store)

    def as_c10d(self) -> dist.Store:
        return self._store


class FileStore(Store):
    """Filesystem-backed store: one file per key in a shared directory;
    atomic publish through rename; a cross-process ``add`` under an
    ``fcntl``-locked file."""

    def __init__(self, path: str, world_size: int = -1,
                 timeout: timedelta = DEFAULT_TIMEOUT):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.world_size = world_size
        self.timeout = timeout

    def _key_path(self, key: str) -> Path:
        safe = key.replace("%", "%25").replace("/", "%2F")
        return self.dir / f"k_{safe}"

    def set(self, key, value) -> None:
        p = self._key_path(key)
        # the temporary name holds the escaped key, the pid and the thread
        # (no clash between writers), and its leading '.' keeps it out of
        # num_keys()'s k_* glob
        tmp = self.dir / f".tmp_{os.getpid()}_{threading.get_ident()}_{p.name}"
        tmp.write_bytes(_to_bytes(value))
        os.replace(tmp, p)

    def get(self, key, timeout=None) -> bytes:
        deadline = time.monotonic() + _resolve_timeout(
            timeout, self.timeout).total_seconds()
        p = self._key_path(key)
        while True:
            try:
                return p.read_bytes()
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise StoreTimeoutError(f"get timed out (key={key!r})")
                time.sleep(0.01)

    def get_nowait(self, key) -> Optional[bytes]:
        try:
            return self._key_path(key).read_bytes()
        except FileNotFoundError:
            return None

    def _locked(self):
        import fcntl

        lf = open(self.dir / ".lock", "w")
        fcntl.flock(lf, fcntl.LOCK_EX)
        return lf

    def add(self, key, amount: int) -> int:
        p = self._key_path(key)
        with self._locked():
            try:
                cur = int(p.read_bytes() or b"0")
            except FileNotFoundError:
                cur = 0
            cur += amount
            self.set(key, str(cur))
            return cur

    def wait(self, keys, timeout=None) -> None:
        deadline = time.monotonic() + _resolve_timeout(
            timeout, self.timeout).total_seconds()
        keys = list(keys)
        while not self.check(keys):
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"wait timed out (keys={keys})")
            time.sleep(0.01)

    def check(self, keys) -> bool:
        return all(self._key_path(k).exists() for k in keys)

    def compare_set(self, key, expected, desired) -> bytes:
        e, d = _to_bytes(expected), _to_bytes(desired)
        with self._locked():
            cur = self.get_nowait(key)
            if (cur is None and not e) or (cur is not None and cur == e):
                self.set(key, d)
                return d
            return e if cur is None else cur

    def delete_key(self, key) -> bool:
        try:
            self._key_path(key).unlink()
            return True
        except FileNotFoundError:
            return False

    def num_keys(self) -> int:
        return sum(1 for _ in self.dir.glob("k_*"))


class PrefixStore(Store):
    """Namespacing wrapper (c10d ``PrefixStore``): per-group isolation on
    one shared store."""

    def __init__(self, prefix: str, store: Store):
        self.prefix = prefix
        self.base = store
        self.timeout = store.timeout

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def set(self, key, value):
        return self.base.set(self._k(key), value)

    def get(self, key, timeout=None):
        return self.base.get(self._k(key), timeout)

    def get_nowait(self, key):
        return self.base.get_nowait(self._k(key))

    def add(self, key, amount):
        return self.base.add(self._k(key), amount)

    def wait(self, keys, timeout=None):
        return self.base.wait([self._k(k) for k in keys], timeout)

    def check(self, keys):
        return self.base.check([self._k(k) for k in keys])

    def compare_set(self, key, expected, desired):
        return self.base.compare_set(self._k(key), expected, desired)

    def delete_key(self, key):
        return self.base.delete_key(self._k(key))

    def num_keys(self):
        return self.base.num_keys()

    def as_c10d(self) -> dist.Store:
        return dist.PrefixStore(self.prefix, self.base.as_c10d())
