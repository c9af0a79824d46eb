"""Watchdog timers: workers arm expiring timers around risky sections;
the agent reaps workers whose timer expired (torch
``distributed/elastic/timer/file_based_local_timer.py``).

Port of ``pytorch_distributed_tpu/elastic/timer.py``, the same file
protocol. A worker hung inside its step (a collective that never
completes, a wedged host) is invisible until a store timeout, minutes
later. A worker that arms ``expires(after=60)`` around its train step gets
killed by its agent within a monitor tick of the deadline, which starts
the normal restart-from-checkpoint path instead of a silent stall.

File-based channel, like torch's: the worker writes
``<dir>/<pid>.json`` atomically (tmp + rename); the agent scans the
directory each monitor tick. No sockets, no extra threads in the worker,
works across fork/spawn, survives worker crashes (the agent GCs files of
dead pids).

Worker::

    timer = WorkerTimer.from_env()        # TPURUN_WATCHDOG_DIR
    for batch in loader:
        with timer.expires(after=120):    # no-op when dir unset
            state, m = trainer.step(state, batch)

Agent: pass ``watchdog_dir`` in :class:`WorkerSpec` (``--watchdog-dir``); the monitor loop kills any worker whose deadline
passed.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import List, Optional

__all__ = ["WorkerTimer", "TimerReaper"]

_ENV_DIR = "TPURUN_WATCHDOG_DIR"


class WorkerTimer:
    """Worker-side timer client. ``dir_path=None`` disables (every call is
    a no-op) so scripts can use it unconditionally."""

    def __init__(self, dir_path: Optional[str], pid: Optional[int] = None):
        self.dir = dir_path
        self.pid = pid or os.getpid()
        self._stack: List[float] = []

    @classmethod
    def from_env(cls) -> "WorkerTimer":
        return cls(os.environ.get(_ENV_DIR))

    def _file(self) -> str:
        return os.path.join(self.dir, f"{self.pid}.json")

    def _write(self) -> None:
        """Publish the earliest live deadline (atomic: tmp + rename)."""
        payload = {"pid": self.pid, "deadline": min(self._stack)}
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=".tmr")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self._file())
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    def _clear_or_rewrite(self) -> None:
        if self._stack:
            self._write()
        else:
            with contextlib.suppress(OSError):
                os.unlink(self._file())

    @contextlib.contextmanager
    def expires(self, *, after: float):
        """Arm a timer for ``after`` seconds around the with-body. Nested
        scopes publish the EARLIEST deadline."""
        if self.dir is None:
            yield
            return
        self._stack.append(time.time() + after)
        self._write()
        try:
            yield
        finally:
            self._stack.pop()
            self._clear_or_rewrite()


class TimerReaper:
    """Agent-side scanner: which worker pids blew their deadline?"""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)

    def expired_pids(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # mid-rename or corrupt — next tick decides
            if payload.get("deadline", float("inf")) < now:
                out.append(int(payload["pid"]))
        return out

    def clear(self, pid: int) -> None:
        """Drop a reaped/dead worker's timer file."""
        with contextlib.suppress(OSError):
            os.unlink(os.path.join(self.dir, f"{pid}.json"))
