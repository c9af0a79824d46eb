"""``elastic_launch``: config, rendezvous store, agent (torch
``launcher/api.py``). Port of ``pytorch_distributed_tpu/elastic/
launcher.py``: the standalone store and the node-0 store are the port's
c10d-backed ``TCPStore``."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import uuid
from typing import Dict, List, Optional

from pytorch_distributed_tpu_torch.distributed.store import PrefixStore, TCPStore
from pytorch_distributed_tpu_torch.elastic.agent import LocalElasticAgent, WorkerSpec
from pytorch_distributed_tpu_torch.elastic.rendezvous import DynamicRendezvous

__all__ = ["LaunchConfig", "elastic_launch"]


@dataclasses.dataclass
class LaunchConfig:
    """torch ``LaunchConfig:48`` parity."""

    nproc_per_node: int = 1
    min_nodes: int = 1
    max_nodes: int = 1
    node_rank: int = 0
    rdzv_endpoint: str = ""  # "host:port"; empty => standalone (host our own)
    run_id: str = ""
    max_restarts: int = 3
    monitor_interval: float = 0.1
    last_call_timeout: float = 2.0
    log_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "tpurun"))
    extra_env: Optional[Dict[str, str]] = None
    watchdog_dir: Optional[str] = None
    #: agent liveness HTTP endpoint port (0 = pick free; None = off) —
    #: torch ``launcher/api.py:241`` health-check-server role
    healthcheck_port: Optional[int] = None


def elastic_launch(config: LaunchConfig, cmd: List[str]) -> None:
    """Run ``cmd`` as an elastic worker group; blocks until success or
    raises ChildFailedError. One call per node (torch ``launch_agent:241``)."""
    run_id = config.run_id or uuid.uuid4().hex[:8]

    owned_store = None
    if not config.rdzv_endpoint:
        # standalone: this process hosts the rendezvous store
        owned_store = TCPStore("127.0.0.1", 0, is_master=True)
        store = owned_store
    else:
        host, port = config.rdzv_endpoint.rsplit(":", 1)
        is_master = config.node_rank == 0
        if is_master:
            store = TCPStore(host, int(port), is_master=True)
        else:
            store = TCPStore(host, int(port))
        owned_store = store

    try:
        rdzv = DynamicRendezvous(
            PrefixStore(f"run:{run_id}", store),
            run_id,
            config.min_nodes,
            config.max_nodes,
            last_call_timeout=config.last_call_timeout,
        )
        spec = WorkerSpec(
            cmd=cmd,
            nproc_per_node=config.nproc_per_node,
            run_id=run_id,
            max_restarts=config.max_restarts,
            monitor_interval=config.monitor_interval,
            log_dir=config.log_dir,
            extra_env=config.extra_env,
            watchdog_dir=config.watchdog_dir,
            healthcheck_port=config.healthcheck_port,
        )
        LocalElasticAgent(spec, rdzv).run()
    finally:
        if owned_store is not None:
            owned_store.close()
