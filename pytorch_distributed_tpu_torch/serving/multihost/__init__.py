"""Multihost serving: an admission router over one scheduler a host.

Port of ``pytorch_distributed_tpu/serving/multihost/``. Each host runs its
own :class:`~pytorch_distributed_tpu_torch.serving.scheduler.Scheduler`
and :class:`InferenceEngine` (the hosts are the dp axis), and a thin
control plane over a store moves requests between them:

  * :mod:`protocol`: the key schema and JSON codecs (the membership join
    counter, per-channel inbox and outbox logs, the load and heartbeat
    snapshot, route incarnations for exactly-once failover), byte for
    byte the reference's;
  * :mod:`worker`: :class:`HostWorker` drains its channel's inbox into the
    local scheduler, streams sequence-numbered token chunks back,
    publishes its load and heartbeat, and can serve the elastic
    ``HealthCheckServer``;
  * :mod:`router`: :class:`Router` admits (occupancy, queue depth and
    pages), routes least-loaded first with a fixed tiebreak, evicts a host
    whose heartbeat stops and re-admits its work as ``prompt +
    committed``, and records route, rebalance and eviction events and
    p50/p99.

Each host's data plane stays its engine (on the card, a decode step is
one CUDA graph replay); only Python control state crosses the store. Any
``Store`` works: ``TCPStore`` between hosts, ``HashStore`` in one process.
"""

from pytorch_distributed_tpu_torch.serving.multihost.protocol import Keys
from pytorch_distributed_tpu_torch.serving.multihost.router import Router
from pytorch_distributed_tpu_torch.serving.multihost.worker import HostWorker

__all__ = ["HostWorker", "Keys", "Router"]
