"""Per-node elastic agent — the worker-group supervisor state machine.

Port of ``pytorch_distributed_tpu/elastic/agent.py`` (torch
``SimpleElasticAgent`` / ``LocalElasticAgent``):

  rendezvous → assign ranks → start workers → monitor loop
    * all SUCCEEDED → exit barrier → done
    * any FAILED    → stop group; restart whole group while
                      ``restarts_remaining > 0`` (whole-group restart is the
                      recovery unit)
    * nodes waiting → membership change: restart group into the next round
                      WITHOUT consuming a retry (scale event ≠ failure)
    * dead node     → treated as a failure of the group

Worker env contract (torch ``run.py:187-238``): RANK, LOCAL_RANK,
WORLD_SIZE, LOCAL_WORLD_SIZE, GROUP_RANK, MASTER_ADDR, MASTER_PORT,
TPURUN_RUN_ID, TPURUN_RESTART_COUNT, TPURUN_MAX_RESTARTS (and
TPURUN_WATCHDOG_DIR with a watchdog). The agent imports nothing that
touches the card: it never initialises CUDA, and every worker incarnation
is a fresh process that builds its own CUDA context and process group.

Two events mark a recovery on the host clock (``observability.
record_event``): ``elastic.group_failed`` when the monitor sees a failed
worker, ``elastic.workers_started`` when a group's processes are started.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import socket
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Optional

from pytorch_distributed_tpu_torch.elastic.multiprocessing import (
    ChildFailedError,
    ProcessFailure,
    WorkerProcess,
    start_worker,
)
from pytorch_distributed_tpu_torch.elastic.rendezvous import DynamicRendezvous
from pytorch_distributed_tpu_torch.observability import record_event

__all__ = ["WorkerSpec", "WorkerGroupState", "LocalElasticAgent"]


class WorkerGroupState(enum.Enum):
    """torch ``WorkerState:212`` parity."""

    INIT = "INIT"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@dataclasses.dataclass
class WorkerSpec:
    cmd: List[str]  # worker command, e.g. [sys.executable, "train.py", ...]
    nproc_per_node: int
    run_id: str = "default"
    max_restarts: int = 3
    monitor_interval: float = 0.1
    log_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "tpurun"))
    extra_env: Optional[Dict[str, str]] = None
    #: directory for worker watchdog timer files (elastic/timer.py); when
    #: set, workers see TPURUN_WATCHDOG_DIR and the agent kills any worker
    #: whose armed deadline expires (torch elastic/timer role)
    watchdog_dir: Optional[str] = None
    #: start an HTTP liveness endpoint on this port (0 = pick free; None
    #: = off) — torch ``launcher/api.py:241`` health-check-server role.
    #: The agent heartbeats it every monitor tick; orchestrator probes
    #: see 503 once the supervision loop wedges.
    healthcheck_port: Optional[int] = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _this_host() -> str:
    return socket.gethostbyname(socket.gethostname())


class LocalElasticAgent:
    """One agent per node; supervises ``nproc_per_node`` worker processes."""

    def __init__(self, spec: WorkerSpec, rdzv: DynamicRendezvous):
        self.spec = spec
        self.rdzv = rdzv
        self.state = WorkerGroupState.INIT
        self.restarts_remaining = spec.max_restarts
        self.restart_count = 0
        self.workers: List[WorkerProcess] = []
        self._group_info = None  # (round, node_rank, num_nodes)
        self._reaper = None
        if spec.watchdog_dir:
            from pytorch_distributed_tpu_torch.elastic.timer import TimerReaper

            self._reaper = TimerReaper(spec.watchdog_dir)
        self.health_server = None
        if spec.healthcheck_port is not None:
            from pytorch_distributed_tpu_torch.elastic.health import (
                HealthCheckServer,
            )

            self.health_server = HealthCheckServer(
                self._health_status, port=spec.healthcheck_port,
                # a monitor_interval >= stale_after would 503 between
                # perfectly healthy ticks
                stale_after=max(10.0, 3 * spec.monitor_interval),
            )

    def _health_status(self) -> dict:
        return {
            "state": self.state.value,
            "restart_count": self.restart_count,
            "run_id": self.spec.run_id,
            "workers": len(self.workers),
        }

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        """Supervise until the group succeeds; raises ChildFailedError when
        retries are exhausted (torch ``_invoke_run:906``)."""
        try:
            # inside the try: a bind failure (EADDRINUSE on a fixed
            # port) must still run the finally's rdzv.shutdown(), or
            # peers wait out the full join timeout
            if self.health_server is not None:
                self.health_server.start()
            self._initialize_workers()
            while True:
                if self.health_server is not None:
                    self.health_server.heartbeat()
                verdict = self._monitor_once()
                if verdict == "running":
                    time.sleep(self.spec.monitor_interval)
                    continue
                if verdict == "succeeded":
                    self.state = WorkerGroupState.SUCCEEDED
                    self._exit_barrier()
                    return
                if verdict == "membership":
                    # scale event: restart into next round, no retry consumed
                    self._stop_workers()
                    self.rdzv.advance_round()
                    self._initialize_workers()
                    continue
                # failed / dead node
                failures = self._collect_failures()
                record_event("elastic.group_failed", run_id=self.spec.run_id,
                             restart_count=self.restart_count,
                             failed_ranks=[f.global_rank for f in failures])
                self.state = WorkerGroupState.FAILED
                self._stop_workers()
                if self.restarts_remaining > 0:
                    self.restarts_remaining -= 1
                    self.restart_count += 1
                    self.rdzv.advance_round()
                    self._initialize_workers()
                    continue
                raise ChildFailedError(
                    f"tpurun:{self.spec.run_id}", failures
                )
        finally:
            self._stop_workers()
            self.rdzv.shutdown()
            if self.health_server is not None:
                self.health_server.stop()

    # -- phases ------------------------------------------------------------
    def _blocking_phase(self, name: str):
        """Health-server phase marker (no-op without a health server):
        rendezvous/barrier waits are EXPECTED-blocking — a liveness probe
        must not kill the agent mid-recovery just because the loop can't
        heartbeat from inside the wait."""
        if self.health_server is not None:
            return self.health_server.blocking_phase(name)
        import contextlib

        return contextlib.nullcontext()

    def _initialize_workers(self) -> None:
        """Rendezvous, publish/read master endpoint, start workers
        (torch ``_rendezvous:519`` + ``_assign_worker_ranks:586``).

        The WHOLE method is an expected-blocking health phase: besides
        the rendezvous wait it blocks up to 60 s on the master-endpoint
        key (node 0 may itself be mid-restart) — un-heartbeated time an
        orchestrator probe must not mistake for a wedge."""
        with self._blocking_phase("initialize_workers"):
            self._initialize_workers_inner()

    def _initialize_workers_inner(self) -> None:
        rnd, node_rank, num_nodes = self.rdzv.next_rendezvous()
        self._group_info = (rnd, node_rank, num_nodes)
        store = self.rdzv.store

        # node 0 picks the workers' master endpoint for this round (on one
        # node, the loopback: every worker is local)
        master_key = f"master/{self.spec.run_id}/{rnd}"
        if node_rank == 0:
            addr = _this_host() if num_nodes > 1 else "127.0.0.1"
            port = _free_port()
            store.set(master_key, f"{addr}:{port}")
        master_addr, master_port = (
            store.get(master_key, timeout=timedelta(seconds=60))
            .decode()
            .rsplit(":", 1)
        )

        nproc = self.spec.nproc_per_node
        world_size = num_nodes * nproc
        self.workers = []
        for local_rank in range(nproc):
            global_rank = node_rank * nproc + local_rank
            env = {
                "RANK": str(global_rank),
                "LOCAL_RANK": str(local_rank),
                "WORLD_SIZE": str(world_size),
                "LOCAL_WORLD_SIZE": str(nproc),
                "GROUP_RANK": str(node_rank),
                "MASTER_ADDR": master_addr,
                "MASTER_PORT": master_port,
                "TPURUN_RUN_ID": self.spec.run_id,
                "TPURUN_RESTART_COUNT": str(self.restart_count),
                "TPURUN_MAX_RESTARTS": str(self.spec.max_restarts),
                **(
                    {"TPURUN_WATCHDOG_DIR": self.spec.watchdog_dir}
                    if self.spec.watchdog_dir else {}
                ),
                **(self.spec.extra_env or {}),
            }
            self.workers.append(
                start_worker(
                    self.spec.cmd,
                    local_rank=local_rank,
                    global_rank=global_rank,
                    env=env,
                    log_dir=f"{self.spec.log_dir}/{self.spec.run_id}"
                            f"/round{rnd}",
                )
            )
        self.state = WorkerGroupState.HEALTHY
        record_event("elastic.workers_started", run_id=self.spec.run_id,
                     round=rnd, restart_count=self.restart_count,
                     pids=[w.proc.pid for w in self.workers])

    def _monitor_once(self) -> str:
        """One monitor tick → 'running' | 'succeeded' | 'failed' |
        'membership' (torch ``_monitor_workers:923``)."""
        # watchdog: kill workers whose armed timer expired (a worker hung
        # inside its step never reaches the store timeout path)
        if self._reaper is not None:
            expired = set(self._reaper.expired_pids())
            for w in self.workers:
                pid = w.proc.pid
                if pid in expired and w.poll() is None:
                    w.terminate(grace=0.5)
                    self._reaper.clear(pid)
        codes = [w.poll() for w in self.workers]
        if any(c is not None and c != 0 for c in codes):
            return "failed"
        if all(c == 0 for c in codes):
            return "succeeded"
        # scale-up detection + dead-node eviction; a peer advancing the
        # round (its group restarted) is also a membership event for us
        if self.rdzv.num_nodes_waiting() > 0 or self.rdzv.round_changed():
            return "membership"
        _, _, num_nodes = self._group_info
        if num_nodes > 1 and self.rdzv.dead_nodes(num_nodes):
            return "failed"
        return "running"

    def _collect_failures(self) -> List[ProcessFailure]:
        failures = []
        for w in self.workers:
            code = w.poll()
            if code is not None and code != 0:
                failures.append(ProcessFailure.from_worker(w, code))
        return failures

    def _stop_workers(self) -> None:
        # sequential terminate grace adds up (hung workers x 5 s) —
        # expected-blocking for the health probe, like initialization
        with self._blocking_phase("stopping_workers"):
            self._stop_workers_inner()

    def _stop_workers_inner(self) -> None:
        for w in self.workers:
            w.terminate()
            # a worker killed mid-`expires` leaves its timer file behind;
            # GC it so a recycled pid in a later round can't inherit the
            # stale deadline and get reaped while healthy
            if self._reaper is not None:
                self._reaper.clear(w.proc.pid)
        self.workers = []
        self.state = WorkerGroupState.STOPPED

    def _exit_barrier(self) -> None:
        """All agents synchronize before returning (torch ``_exit_barrier``)
        so fast nodes don't tear down the store under slow ones."""
        rnd, node_rank, num_nodes = self._group_info
        try:
            with self._blocking_phase("exit_barrier"):
                self.rdzv.store.barrier_id(
                    f"exit/{self.spec.run_id}/{rnd}",
                    node_rank,
                    num_nodes,
                    timeout=timedelta(seconds=300),
                )
        except Exception:
            pass  # best effort: peers may already be gone
