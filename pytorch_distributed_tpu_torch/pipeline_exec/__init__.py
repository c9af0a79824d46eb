"""Pipelined step execution: keep the device queue full.

Port of ``pytorch_distributed_tpu/pipeline_exec``. :class:`AsyncRunner`
runs the trainer's whole step as one program (a CUDA graph replay on the
card) that also writes the step's metrics into an on-device
:class:`MetricRing`; the host only dispatches, at most ``depth`` steps
ahead, starts a non-blocking copy of the ring every ``drain_every`` steps,
and blocks once, at :meth:`AsyncRunner.finish`.

Typical use (or the :meth:`..trainer.Trainer.run` facade)::

    runner = AsyncRunner(trainer, depth=2, drain_every=32)
    runner.start(state, first_batch)
    for batch in batches:
        runner.submit(batch)
    state, history = runner.finish()   # the one host sync
    history["loss"]                     # per-step series
"""

from pytorch_distributed_tpu_torch.pipeline_exec.metric_ring import MetricRing
from pytorch_distributed_tpu_torch.pipeline_exec.runner import (
    AsyncRunner,
    MetricHistory,
)

__all__ = ["AsyncRunner", "MetricHistory", "MetricRing"]
