"""Worker processes and their failures.

Port of ``pytorch_distributed_tpu/elastic/multiprocessing.py`` (torch
``elastic/multiprocessing``): :func:`start_worker` (a fresh ``Popen``
process with the launcher's environment, output to a log file),
``ProcessFailure``/``ChildFailedError`` (structured failure records), and
the ``@record`` decorator that writes a worker's uncaught exception as
JSON to ``$TPURUN_ERROR_FILE`` for the agent to read back. Workers are
fresh processes, so each incarnation builds its own CUDA context, NCCL
group, cuDNN plans and graph captures.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "ProcessFailure",
    "ChildFailedError",
    "record",
    "WorkerProcess",
    "start_worker",
]

ERROR_FILE_ENV = "TPURUN_ERROR_FILE"


@dataclasses.dataclass
class ProcessFailure:
    """One worker's failure record (torch ``ProcessFailure:92``)."""

    local_rank: int
    global_rank: int
    pid: int
    exitcode: int
    error_file: str
    message: str = ""
    timestamp: float = 0.0

    @classmethod
    def from_worker(cls, w: "WorkerProcess", exitcode: int) -> "ProcessFailure":
        message = ""
        ts = time.time()
        try:
            payload = json.loads(Path(w.error_file).read_text())
            message = payload.get("message", "")
            ts = payload.get("timestamp", ts)
        except (OSError, json.JSONDecodeError):
            if exitcode < 0:
                try:
                    name = signal.Signals(-exitcode).name
                except ValueError:  # e.g. real-time signals w/o enum names
                    name = str(-exitcode)
                message = f"killed by signal {name}"
            else:
                message = f"exitcode {exitcode} (no error file)"
        return cls(
            local_rank=w.local_rank,
            global_rank=w.global_rank,
            pid=w.proc.pid,
            exitcode=exitcode,
            error_file=w.error_file,
            message=message,
            timestamp=ts,
        )


class ChildFailedError(RuntimeError):
    """Raised by the launcher when workers fail permanently
    (torch ``ChildFailedError:205``)."""

    def __init__(self, name: str, failures: List[ProcessFailure]):
        self.name = name
        self.failures = failures
        lines = [f"{name} failed ({len(failures)} failure(s)):"]
        for f in failures:
            lines.append(
                f"  rank {f.global_rank} (local {f.local_rank}, pid {f.pid}) "
                f"exitcode {f.exitcode}: {f.message}"
            )
        super().__init__("\n".join(lines))


def record(fn):
    """Decorator for worker entrypoints: uncaught exceptions are written as
    JSON to $TPURUN_ERROR_FILE before re-raising, so the agent can surface
    the real traceback instead of just an exit code."""

    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SystemExit:
            raise
        except BaseException as e:
            error_file = os.environ.get(ERROR_FILE_ENV)
            if error_file:
                payload = {
                    "message": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                    "timestamp": time.time(),
                    "rank": int(os.environ.get("RANK", -1)),
                    "local_rank": int(os.environ.get("LOCAL_RANK", -1)),
                }
                try:
                    Path(error_file).write_text(json.dumps(payload, indent=2))
                except OSError:
                    pass
            raise

    return wrapper


@dataclasses.dataclass
class WorkerProcess:
    local_rank: int
    global_rank: int
    proc: subprocess.Popen
    error_file: str
    log_file: str

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self, grace: float = 5.0) -> None:
        if self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def tail_log(self, n: int = 20) -> str:
        try:
            lines = Path(self.log_file).read_text().splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return ""


def start_worker(
    cmd: List[str],
    *,
    local_rank: int,
    global_rank: int,
    env: Dict[str, str],
    log_dir: str,
) -> WorkerProcess:
    """Spawn one worker with the launcher env contract + log/error files."""
    logs = Path(log_dir)
    logs.mkdir(parents=True, exist_ok=True)
    log_file = str(logs / f"worker_{global_rank}.log")
    error_file = str(logs / f"worker_{global_rank}_error.json")
    Path(error_file).unlink(missing_ok=True)

    full_env = dict(os.environ)
    full_env.update(env)
    full_env[ERROR_FILE_ENV] = error_file

    with open(log_file, "ab") as lf:
        proc = subprocess.Popen(
            cmd, env=full_env, stdout=lf, stderr=subprocess.STDOUT
        )
    return WorkerProcess(
        local_rank=local_rank,
        global_rank=global_rank,
        proc=proc,
        error_file=error_file,
        log_file=log_file,
    )
