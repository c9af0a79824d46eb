"""graftlint rule modules: importing this package registers every rule
with the core registry (see ``core.register``).

The reference's ``donated-buffer-reuse``, ``recompile-hazard``,
``tracer-leak`` and ``rng-key-reuse`` guard failure modes of JAX
(donation, retracing, tracers, functional keys) and have no rule here
(ROADMAP C); the runtime counterpart of a recompile is the IR tier's
program count (``analysis.ir``)."""

from pytorch_distributed_tpu_torch.analysis.rules import (  # noqa: F401
    coalesce,
    collectives,
    host_sync,
    reshard,
)
