"""Eager process groups of the port: ReduceOp, Work, ProcessGroup, the
desync-checking wrapper and the fake group.

Port of ``pytorch_distributed_tpu/distributed/process_group.py``. The
reference runs its collectives over numpy arrays through its own
transports (``StoreBackend`` over the store, a C++ TCP backend, compiled
XLA programs); here c10d's NCCL (on the card) and gloo (on the CPU, or
ranks sharing a card) are the transport, so the port keeps the reference's
API and names over them and not its transport:

* :class:`ReduceOp` (SUM, PRODUCT, MIN, MAX, AVG) maps onto c10d's ops;
  AVG is a sum divided by the group size in the tensor's dtype, as the
  reference's mean is a sum and a division, so it does not depend on a
  backend's own AVG;
* :class:`Work` wraps c10d's work objects (``wait``, ``is_completed``,
  ``is_success``, ``result``, ``exception``); ``result()`` waits and
  returns the collective's output tensors;
* :class:`Backend` is the collective set over tensors: :class:`C10dBackend`
  runs it on one c10d group (or a c10d backend object built from a store,
  as ``shrink_group`` makes), :class:`FakeBackend` is the reference's
  identity group for single-process simulation of any world size;
* :class:`ProcessGroup` adds sequence numbers, async handles, the object
  collectives and one ``collective`` event (op, group, bytes, world size,
  ``duration_ms``) and one ``pg.<op>`` metric per collective
  (``observability.record_event`` / ``put_metric``), recorded when the
  collective completes; each collective is also an entry of the
  process-global flight recorder (``observability.get_flight_recorder``:
  recorded with op, group and bytes when it is issued, completed ``ok`` or
  failed when its work completes), and its issue runs inside a
  ``pg::<op>[<group>]`` profiler region (``observability.annotate``);
* :class:`ProcessGroupWrapper` checks, before each collective, that every
  rank issues the same op on the same shape and dtype, through the group's
  store, and raises with a per-rank report where they differ.

Tensors go in and come out on the group's device (the card for NCCL);
``all_reduce``, ``broadcast`` and ``reduce`` work in place and return the
tensor they were given, as c10d does. Receiving calls take the tensor to
receive into (``recv(out, src)``), since c10d receives into a buffer.
"""

from __future__ import annotations

import pickle
import threading
import time
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.observability import (
    annotate,
    get_flight_recorder,
    put_metric,
    record_event,
)

__all__ = [
    "ReduceOp",
    "Work",
    "Backend",
    "C10dBackend",
    "FakeBackend",
    "ProcessGroup",
    "ProcessGroupWrapper",
]


class ReduceOp(Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"

    @property
    def c10d(self) -> dist.ReduceOp:
        """The c10d op that runs this one (AVG runs as SUM, then divides)."""
        return {ReduceOp.SUM: dist.ReduceOp.SUM,
                ReduceOp.AVG: dist.ReduceOp.SUM,
                ReduceOp.MAX: dist.ReduceOp.MAX,
                ReduceOp.MIN: dist.ReduceOp.MIN,
                ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}[self]


class Work:
    """Handle of one collective (c10d ``Work``). ``wait()`` blocks until
    the c10d works behind it completed and returns the collective's output,
    re-raising a backend error; ``result()`` is the same."""

    def __init__(self, works: Sequence = (), finish: Callable[[], Any] = None,
                 op_name: str = ""):
        self._works = list(works)
        self._finish = finish
        self.op_name = op_name
        self._value = None
        self._exc: Optional[BaseException] = None
        self._done = False
        #: called once, with the exception or None, when the work completes
        self.on_done: Optional[Callable] = None

    def wait(self, timeout: Optional[timedelta] = None):
        if not self._done:
            try:
                for w in self._works:
                    w.wait() if timeout is None else w.wait(timeout)
                self._value = self._finish() if self._finish else None
            except Exception as e:
                self._exc = e
                self._complete()
                raise
            self._complete()
        if self._exc is not None:
            raise self._exc
        return self._value

    def _complete(self) -> None:
        self._done = True
        if self.on_done is not None:
            callback, self.on_done = self.on_done, None
            callback(self._exc)

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)

    def is_success(self) -> bool:
        return self._done and self._exc is None

    def result(self):
        return self.wait()

    def exception(self) -> Optional[BaseException]:
        return self._exc


def _done(value=None, op_name: str = "") -> Work:
    return Work((), lambda: value, op_name)


class Backend:
    """The collective set over tensors of one group of ranks. Every method
    returns a :class:`Work`; ``op`` is a :class:`ReduceOp` and ranks are
    the group's own."""

    rank: int
    world_size: int

    def broadcast(self, t, src): raise NotImplementedError
    def all_reduce(self, t, op): raise NotImplementedError
    def reduce(self, t, dst, op): raise NotImplementedError
    def all_gather(self, t): raise NotImplementedError
    def gather(self, t, dst): raise NotImplementedError
    def scatter(self, tensors, out, src): raise NotImplementedError
    def reduce_scatter(self, t, op): raise NotImplementedError
    def all_to_all(self, tensors): raise NotImplementedError
    def send(self, t, dst, tag): raise NotImplementedError
    def recv(self, out, src, tag): raise NotImplementedError
    def barrier(self): raise NotImplementedError

    def shutdown(self) -> None:
        pass


def _avg(t: torch.Tensor, op: ReduceOp, n: int) -> torch.Tensor:
    if op is ReduceOp.AVG:
        if t.is_floating_point():
            t.div_(n)
        else:
            t.copy_(torch.div(t, n, rounding_mode="floor"))
    return t


class C10dBackend(Backend):
    """The collectives of one c10d group: a ``torch.distributed``
    ``ProcessGroup`` (the default group, ``new_group``'s) or a c10d backend
    object (``ProcessGroupGloo``/``ProcessGroupNCCL`` built from a store).
    Each call goes to the object's own methods with group ranks, so a group
    that c10d's registry does not know (a shrunk group) works the same."""

    def __init__(self, group):
        self.group = group
        self.rank = group.rank()
        self.world_size = group.size()

    def broadcast(self, t, src):
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        return Work([self.group.broadcast([t], opts)], lambda: t)

    def all_reduce(self, t, op):
        opts = dist.AllreduceOptions()
        opts.reduceOp = op.c10d
        return Work([self.group.allreduce([t], opts)],
                    lambda: _avg(t, op, self.world_size))

    def reduce(self, t, dst, op):
        opts = dist.ReduceOptions()
        opts.reduceOp, opts.rootRank, opts.rootTensor = op.c10d, dst, 0
        return Work([self.group.reduce([t], opts)],
                    lambda: _avg(t, op, self.world_size)
                    if self.rank == dst else None)

    def all_gather(self, t):
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        return Work([self.group.allgather([out], [t])], lambda: out)

    def gather(self, t, dst):
        out = ([[torch.empty_like(t) for _ in range(self.world_size)]]
               if self.rank == dst else [])
        opts = dist.GatherOptions()
        opts.rootRank = dst
        return Work([self.group.gather(out, [t], opts)],
                    lambda: out[0] if out else None)

    def scatter(self, tensors, out, src):
        opts = dist.ScatterOptions()
        opts.rootRank = src
        inputs = [list(tensors)] if self.rank == src else []
        return Work([self.group.scatter([out], inputs, opts)], lambda: out)

    def reduce_scatter(self, t, op):
        out = t.new_empty((t.shape[0] // self.world_size,) + t.shape[1:])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = op.c10d
        return Work([self.group._reduce_scatter_base(out, t.contiguous(),
                                                     opts)],
                    lambda: _avg(out, op, self.world_size))

    def all_to_all(self, tensors):
        inp = torch.stack(list(tensors)).contiguous()
        out = torch.empty_like(inp)
        return Work([self.group.alltoall_base(out, inp, [], [],
                                              dist.AllToAllOptions())],
                    lambda: list(out.unbind(0)))

    def send(self, t, dst, tag):
        return Work([self.group.send([t], dst, tag)], lambda: None)

    def recv(self, out, src, tag):
        return Work([self.group.recv([out], src, tag)], lambda: out)

    def barrier(self):
        return Work([self.group.barrier(dist.BarrierOptions())], lambda: None)


class FakeBackend(Backend):
    """No-op backend (c10d ``FakeProcessGroup``): every op completes at once
    with the identity result, as if every rank held this rank's tensors; a
    single process simulates any world size."""

    def __init__(self, store=None, rank: int = 0, world_size: int = 1):
        self.store = store
        self.rank = rank
        self.world_size = world_size

    def broadcast(self, t, src):
        return _done(t)

    def all_reduce(self, t, op):
        return _done(t)

    def reduce(self, t, dst, op):
        return _done(t if self.rank == dst else None)

    def all_gather(self, t):
        return _done([t.clone() for _ in range(self.world_size)])

    def gather(self, t, dst):
        return _done([t.clone() for _ in range(self.world_size)]
                     if self.rank == dst else None)

    def scatter(self, tensors, out, src):
        if self.rank == src and tensors:
            out.copy_(tensors[self.rank])
        return _done(out)

    def reduce_scatter(self, t, op):
        chunk = t.shape[0] // self.world_size
        return _done(t[self.rank * chunk:(self.rank + 1) * chunk].clone())

    def all_to_all(self, tensors):
        return _done([t.clone() for t in tensors])

    def send(self, t, dst, tag):
        return _done()

    def recv(self, out, src, tag):
        raise RuntimeError("FakeBackend cannot recv (no peer data)")

    def barrier(self):
        return _done()


class ProcessGroup:
    """Collective facade over a :class:`Backend`: sequence numbers, async
    :class:`Work` handles, object collectives, and a ``collective`` event
    and ``pg.<op>`` metric per collective.

    ``store`` (a c10d store, the group's namespace) is what the desync
    wrapper exchanges its checks through; ``device`` is where the object
    collectives stage their bytes (the card for NCCL).
    """

    def __init__(self, backend: Backend, group_name: str = "default", *,
                 store: Optional[dist.Store] = None,
                 device: Optional[torch.device] = None):
        self.backend = backend
        self.group_name = group_name
        self.store = store
        self.device = torch.device(device) if device is not None else (
            torch.device("cpu"))
        self._seq = 0
        self._lock = threading.Lock()
        # every collective is an entry of the flight recorder; a recorder
        # that cannot load (no host compiler) leaves the data path running
        try:
            self._fr = get_flight_recorder()
        except Exception:
            self._fr = None

    @property
    def rank(self) -> int:
        return self.backend.rank

    @property
    def world_size(self) -> int:
        return self.backend.world_size

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _submit(self, issue: Callable[[], Work], op_name: str,
                async_op: bool, nbytes: int = 0) -> Work:
        self.next_seq()
        fr = self._fr
        entry = fr.record(op_name, self.group_name, nbytes) if fr else None
        t0 = time.perf_counter()

        def done(exc):
            if fr is not None:
                fr.complete(entry, ok=exc is None)
            if exc is not None:
                record_event("collective_failed", op=op_name,
                             group=self.group_name, nbytes=nbytes)
                return
            record_event("collective", op=op_name, group=self.group_name,
                         nbytes=nbytes, world_size=self.world_size,
                         duration_ms=round((time.perf_counter() - t0) * 1e3,
                                           3))
            put_metric(f"pg.{op_name}")

        try:
            with annotate(f"pg::{op_name}[{self.group_name}]"):
                work = issue()
        except Exception as e:
            done(e)
            raise
        work.op_name = op_name
        work.on_done = done
        if not async_op:
            work.wait()
        return work

    # -- collective API (tensors in and out) ------------------------------
    def broadcast(self, t, src: int = 0, *, async_op=False) -> Work:
        return self._submit(lambda: self.backend.broadcast(t, src),
                            "broadcast", async_op, _nbytes(t))

    def all_reduce(self, t, op: ReduceOp = ReduceOp.SUM, *,
                   async_op=False) -> Work:
        return self._submit(lambda: self.backend.all_reduce(t, op),
                            "all_reduce", async_op, _nbytes(t))

    def reduce(self, t, dst: int, op: ReduceOp = ReduceOp.SUM, *,
               async_op=False) -> Work:
        return self._submit(lambda: self.backend.reduce(t, dst, op),
                            "reduce", async_op, _nbytes(t))

    def all_gather(self, t, *, async_op=False) -> Work:
        return self._submit(lambda: self.backend.all_gather(t),
                            "all_gather", async_op, _nbytes(t))

    def gather(self, t, dst: int = 0, *, async_op=False) -> Work:
        return self._submit(lambda: self.backend.gather(t, dst), "gather",
                            async_op, _nbytes(t))

    def scatter(self, tensors, src: int = 0, *, out=None,
                async_op=False) -> Work:
        """Rank ``r`` gets ``tensors[r]`` of ``src``. A rank other than
        ``src`` passes ``out`` (or a list whose entry ``r`` it is shaped
        like): c10d receives into a buffer."""
        if self.rank == src and (tensors is None
                                 or len(tensors) != self.world_size):
            raise ValueError("scatter src needs world_size tensors")
        if out is None:
            if tensors is None:
                raise ValueError("scatter: pass out= on a rank that is not "
                                 "the source")
            out = torch.empty_like(tensors[self.rank])
        return self._submit(lambda: self.backend.scatter(tensors, out, src),
                            "scatter", async_op, _nbytes(out))

    def reduce_scatter(self, t, op: ReduceOp = ReduceOp.SUM, *,
                       async_op=False) -> Work:
        if t.shape[0] % self.world_size:
            raise ValueError(
                f"reduce_scatter dim 0 ({t.shape[0]}) not divisible by "
                f"world size {self.world_size}")
        return self._submit(lambda: self.backend.reduce_scatter(t, op),
                            "reduce_scatter", async_op, _nbytes(t))

    def all_to_all(self, tensors, *, async_op=False) -> Work:
        """Chunk ``r`` of this rank goes to rank ``r``; every chunk has one
        shape (c10d's ``all_to_all_single`` over their stack)."""
        if len(tensors) != self.world_size:
            raise ValueError("all_to_all needs world_size input chunks")
        return self._submit(lambda: self.backend.all_to_all(tensors),
                            "all_to_all", async_op,
                            sum(_nbytes(t) for t in tensors))

    def send(self, t, dst: int, tag: int = 0) -> None:
        self.backend.send(t, dst, tag).wait()

    def recv(self, out, src: int, tag: int = 0) -> torch.Tensor:
        return self.backend.recv(out, src, tag).wait()

    def isend(self, t, dst: int, tag: int = 0) -> Work:
        return self.backend.send(t, dst, tag)

    def irecv(self, out, src: int, tag: int = 0) -> Work:
        return self.backend.recv(out, src, tag)

    def barrier(self, *, async_op=False) -> Work:
        return self._submit(self.backend.barrier, "barrier", async_op)

    # -- object collectives (pickle payloads) ------------------------------
    # Two phases, as torch's: the payload lengths first, then every payload
    # padded to the longest, so every rank issues collectives of one shape
    # (which the desync wrapper holds them to).
    def _padded_payload(self, obj: Any):
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        size = torch.tensor([payload.numel()], dtype=torch.int64,
                            device=self.device)
        sizes = [int(s) for s in self.all_gather(size).result()]
        padded = torch.zeros(max(sizes), dtype=torch.uint8,
                             device=self.device)
        padded[:payload.numel()] = payload.to(self.device)
        return padded, sizes

    def all_gather_object(self, obj: Any) -> List[Any]:
        padded, sizes = self._padded_payload(obj)
        gathered = self.all_gather(padded).result()
        return [_unpickle(a[:n]) for a, n in zip(gathered, sizes)]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        data = pickle.dumps(obj) if self.rank == src else b""
        size = torch.tensor([len(data)], dtype=torch.int64,
                            device=self.device)
        n = int(self.broadcast(size, src).result())
        buf = torch.zeros(n, dtype=torch.uint8, device=self.device)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        return _unpickle(self.broadcast(buf, src).result())

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        padded, sizes = self._padded_payload(obj)
        out = self.gather(padded, dst).result()
        if out is None:
            return None
        return [_unpickle(a[:n]) for a, n in zip(out, sizes)]

    def shutdown(self) -> None:
        self.backend.shutdown()


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if t is not None else 0


def _unpickle(t: torch.Tensor) -> Any:
    return pickle.loads(t.cpu().numpy().tobytes())


class ProcessGroupWrapper(ProcessGroup):
    """Shadow verification (``TORCH_DISTRIBUTED_DEBUG=DETAIL``): before each
    collective every rank posts ``(op, shape, dtype)`` to the group's store
    under the collective's sequence number and reads every other rank's; a
    mismatch raises with a per-rank report, before the collective runs and
    corrupts data or hangs."""

    def __init__(self, backend: Backend, group_name: str = "default", *,
                 store: Optional[dist.Store] = None,
                 device: Optional[torch.device] = None,
                 timeout: timedelta = timedelta(seconds=300)):
        if store is None:
            raise ValueError("ProcessGroupWrapper checks through a store")
        super().__init__(backend, group_name, store=store, device=device)
        self.timeout = timeout

    def _verify(self, op_name: str, t) -> None:
        desc = {"op": op_name,
                "shape": tuple(t.shape) if t is not None else None,
                "dtype": str(t.dtype) if t is not None else None}
        seq = self.next_seq()
        store, n = self.store, self.world_size
        store.set(f"verify/{seq}/{self.rank}", pickle.dumps(desc))
        store.wait([f"verify/{seq}/{r}" for r in range(n)], self.timeout)
        descs = [pickle.loads(store.get(f"verify/{seq}/{r}"))
                 for r in range(n)]
        if store.add(f"verify/{seq}/acks", 1) == n:
            for r in range(n):
                store.delete_key(f"verify/{seq}/{r}")
            store.delete_key(f"verify/{seq}/acks")
        if any(d != descs[0] for d in descs[1:]):
            report = "\n".join(f"  rank {i}: {d}" for i, d in enumerate(descs))
            raise RuntimeError(f"collective desync detected in group "
                               f"{self.group_name!r}:\n{report}")

    def broadcast(self, t, src: int = 0, *, async_op=False):
        self._verify("broadcast", t)
        return super().broadcast(t, src, async_op=async_op)

    def all_reduce(self, t, op=ReduceOp.SUM, *, async_op=False):
        self._verify(f"all_reduce.{op.value}", t)
        return super().all_reduce(t, op, async_op=async_op)

    def reduce_scatter(self, t, op=ReduceOp.SUM, *, async_op=False):
        self._verify(f"reduce_scatter.{op.value}", t)
        return super().reduce_scatter(t, op, async_op=async_op)

    def all_gather(self, t, *, async_op=False):
        self._verify("all_gather", t)
        return super().all_gather(t, async_op=async_op)

    def barrier(self, *, async_op=False):
        self._verify("barrier", None)
        return super().barrier(async_op=async_op)
