"""The elastic launcher of the port (torchrun / torchelastic).

Port of ``pytorch_distributed_tpu/elastic``:

  * ``run``             -- the command line (``python -m
    pytorch_distributed_tpu_torch.elastic.run``, torchrun's flags);
  * ``launcher``        -- ``elastic_launch(LaunchConfig, cmd)``;
  * ``agent``           -- the per-node supervisor: rendezvous, ranks,
    worker start, monitor, restart of the whole group on a failure, a
    re-rendezvous on a change of membership;
  * ``rendezvous``      -- store-backed dynamic membership with keep-alive
    heartbeats and dead-node eviction;
  * ``multiprocessing`` -- worker processes, logs, JSON error files,
    ``@record``;
  * ``timer``, ``health`` -- worker watchdog timers, the agent's liveness
    endpoint;
  * ``resume``          -- restore the newest checkpoint onto the current
    world, or move a live state onto it (``reshard_state`` onto
    ``state_shardings``; a pipeline's state through ``placed_state``).

The stores are ``distributed.store``'s (a c10d ``TCPStore`` by default).
A restart starts fresh worker processes: each incarnation builds its own
CUDA context, NCCL group, cuDNN plans and graph captures; the agent never
touches the card.
"""

from pytorch_distributed_tpu_torch.elastic.agent import (
    LocalElasticAgent,
    WorkerGroupState,
    WorkerSpec,
)
from pytorch_distributed_tpu_torch.elastic.health import HealthCheckServer
from pytorch_distributed_tpu_torch.elastic.launcher import (
    LaunchConfig,
    elastic_launch,
)
from pytorch_distributed_tpu_torch.elastic.multiprocessing import (
    ChildFailedError,
    ProcessFailure,
    record,
)
from pytorch_distributed_tpu_torch.elastic.rendezvous import DynamicRendezvous
from pytorch_distributed_tpu_torch.elastic.resume import (
    placed_state,
    reshard_state,
    resume_from_checkpoint,
    state_shardings,
)
from pytorch_distributed_tpu_torch.elastic.timer import TimerReaper, WorkerTimer

__all__ = [
    "WorkerTimer",
    "TimerReaper",
    "DynamicRendezvous",
    "HealthCheckServer",
    "LocalElasticAgent",
    "WorkerGroupState",
    "WorkerSpec",
    "LaunchConfig",
    "elastic_launch",
    "ChildFailedError",
    "ProcessFailure",
    "record",
    "resume_from_checkpoint",
    "reshard_state",
    "state_shardings",
    "placed_state",
]
