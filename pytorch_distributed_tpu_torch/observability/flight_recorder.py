"""FlightRecorder: the ring buffer of eager collectives, its stall
watchdog, and ``fr_trace``.

Port of ``pytorch_distributed_tpu/observability/flight_recorder.py``. The
ring and the watchdog are the port's own copy of the reference's C++
(``observability/csrc/flightrecorder.cpp``, a plain C interface), built
with ``g++`` at first use into ``_build/`` (``ops._build.load(name,
host=True)``) and bound with ctypes. Every eager ``ProcessGroup`` collective is recorded in
the process-global recorder (:func:`get_flight_recorder`) when it is
issued and completed (``ok`` or failed) when its work completes; the
watchdog thread dumps the ring to a file when the oldest collective in
flight passes a timeout and sets a flag (:meth:`FlightRecorder.stalled`).

The capacity is ``TORCH_FR_BUFFER_SIZE`` (default 2048), torch's name for
its own recorder's size, which the reference maps its
``TPU_FR_BUFFER_SIZE`` to. torch's NCCL process groups read the same
variable, so setting it also turns on torch's own flight recorder in them.
That one sees NCCL's work only; this one sees the port's eager API on any
backend.

A dump is ``{"entries": [...]}``, each entry with the keys ``id``, ``op``,
``group``, ``bytes``, ``status`` (``scheduled``, ``completed``,
``failed``), ``t_sched`` and ``t_done``, as the reference's: each
package's :func:`fr_trace` reads the other's dumps.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import List, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "fr_trace"]


def _bind_fr(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        "tpufr_create": ([c.c_int64], c.c_void_p),
        "tpufr_free": ([c.c_void_p], None),
        "tpufr_record": (
            [c.c_void_p, c.c_char_p, c.c_char_p, c.c_int64], c.c_int64),
        "tpufr_complete": ([c.c_void_p, c.c_int64, c.c_int], c.c_int),
        "tpufr_dump_json": ([c.c_void_p], c.c_void_p),
        "tpufr_buf_free": ([c.c_void_p], None),
        "tpufr_dump_file": ([c.c_void_p, c.c_char_p], c.c_int),
        "tpufr_oldest_inflight_age": ([c.c_void_p], c.c_double),
        "tpufr_watchdog_start": (
            [c.c_void_p, c.c_double, c.c_char_p, c.c_double], None),
        "tpufr_watchdog_stop": ([c.c_void_p], None),
        "tpufr_stalled": ([c.c_void_p], c.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


class FlightRecorder:
    """Ring buffer of collective ops (C++), with an optional stall
    watchdog."""

    def __init__(self, capacity: Optional[int] = None):
        from pytorch_distributed_tpu_torch.ops import _build

        self._lib = _bind_fr(_build.load("flightrecorder", host=True))
        if capacity is None:
            capacity = int(os.environ.get("TORCH_FR_BUFFER_SIZE", "2048"))
        self._h = self._lib.tpufr_create(capacity)
        self.capacity = capacity

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tpufr_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- recording -----------------------------------------------------------
    def record(self, op: str, group: str = "default", nbytes: int = 0) -> int:
        """Record a scheduled collective; returns its entry id."""
        return self._lib.tpufr_record(self._h, op.encode(), group.encode(),
                                      nbytes)

    def complete(self, entry_id: int, ok: bool = True) -> None:
        self._lib.tpufr_complete(self._h, entry_id, 1 if ok else 0)

    # -- inspection ----------------------------------------------------------
    def dump(self) -> List[dict]:
        """The entries in id order (the newest ``capacity`` of them)."""
        p = self._lib.tpufr_dump_json(self._h)
        try:
            data = ctypes.string_at(p).decode()
        finally:
            self._lib.tpufr_buf_free(p)
        return json.loads(data)["entries"]

    def dump_to_file(self, path: str) -> None:
        if self._lib.tpufr_dump_file(self._h, path.encode()) != 0:
            raise OSError(f"cannot write flight-recorder dump to {path}")

    def oldest_inflight_age(self) -> Optional[float]:
        """Seconds since the oldest collective still in flight was issued
        (None: none is)."""
        age = self._lib.tpufr_oldest_inflight_age(self._h)
        return None if age < 0 else age

    # -- watchdog ------------------------------------------------------------
    def start_watchdog(self, timeout_s: float, dump_path: str,
                       poll_interval_s: float = 1.0) -> None:
        """A background C++ thread: when the oldest collective in flight
        passes ``timeout_s``, it dumps the ring to ``dump_path`` and sets
        the stalled flag (poll it with :meth:`stalled`)."""
        self._lib.tpufr_watchdog_start(self._h, timeout_s, dump_path.encode(),
                                       poll_interval_s)

    def stop_watchdog(self) -> None:
        self._lib.tpufr_watchdog_stop(self._h)

    def stalled(self) -> bool:
        return bool(self._lib.tpufr_stalled(self._h))


_global_fr: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global recorder the eager ``ProcessGroup`` writes to
    (built and loaded at the first call)."""
    global _global_fr
    with _global_lock:
        if _global_fr is None:
            _global_fr = FlightRecorder()
        return _global_fr


def fr_trace(entries_or_path) -> dict:
    """Analyze a flight-recorder dump (a path, or the entries): op counts,
    the ops in flight with the oldest as ``hang_suspect``, the failed ones,
    and the completed ones' mean and largest latency (torch
    ``fr_trace.py``'s role)."""
    if isinstance(entries_or_path, str):
        with open(entries_or_path) as f:
            entries = json.load(f)["entries"]
    else:
        entries = list(entries_or_path)

    by_op: dict = {}
    inflight = []
    latencies = []
    for e in entries:
        by_op[e["op"]] = by_op.get(e["op"], 0) + 1
        if e["status"] == "scheduled":
            inflight.append(e)
        elif e["status"] == "completed" and e["t_done"] >= e["t_sched"]:
            latencies.append(e["t_done"] - e["t_sched"])
    report = {
        "total": len(entries),
        "by_op": by_op,
        "inflight": inflight,
        "failed": [e for e in entries if e["status"] == "failed"],
        "latency_avg_s": (sum(latencies) / len(latencies)) if latencies
        else None,
        "latency_max_s": max(latencies) if latencies else None,
    }
    if inflight:
        report["hang_suspect"] = min(inflight, key=lambda e: e["id"])
    return report
