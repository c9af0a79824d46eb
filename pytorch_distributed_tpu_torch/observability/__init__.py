"""Observability and debugging of the port.

Port of ``pytorch_distributed_tpu/observability``, module for module:

  * ``flight_recorder`` -- ``FlightRecorder``, the C++ ring of eager
    collectives with its stall watchdog and dump-on-hang (the port's copy
    of the reference's C++, built with ``g++`` at first use), the
    process-global ``get_flight_recorder`` that every eager
    ``ProcessGroup`` collective is recorded in, and ``fr_trace``, the dump
    analyzer (torch ``fr_trace.py``);
  * ``logging_utils`` -- ``exception_logger``/``time_logger`` (torch
    ``c10d_logger``'s decorators); ``Event``/``record_event`` with
    ``add_event_handler``, ``put_metric``/``get_metrics`` (torch
    ``elastic/events`` and ``elastic/metrics``); ``debug_level`` (OFF,
    INFO, DETAIL from ``TORCH_DISTRIBUTED_DEBUG``; DETAIL also turns on the
    process groups' desync checks); ``nan_check``; ``IterationLogger``
    (DDP's per-iteration stats); ``LatencyTracker`` and ``RatioTracker``
    (serving's percentiles and rates);
  * ``profiler`` -- ``profile_trace``, ``annotate``,
    ``trace_op_breakdown``, ``memory_breakdown`` and ``StepProfiler`` on
    ``torch.profiler``.
"""

from pytorch_distributed_tpu_torch.observability.flight_recorder import (
    FlightRecorder,
    fr_trace,
    get_flight_recorder,
)
from pytorch_distributed_tpu_torch.observability.logging_utils import (
    DebugLevel,
    Event,
    IterationLogger,
    LatencyTracker,
    RatioTracker,
    add_event_handler,
    debug_level,
    exception_logger,
    get_metrics,
    nan_check,
    put_metric,
    recent_events,
    record_event,
    time_logger,
)
from pytorch_distributed_tpu_torch.observability.profiler import (
    StepProfiler,
    annotate,
    memory_breakdown,
    profile_trace,
    trace_op_breakdown,
)

__all__ = [
    "StepProfiler", "memory_breakdown", "trace_op_breakdown",
    "FlightRecorder",
    "get_flight_recorder",
    "fr_trace",
    "DebugLevel",
    "debug_level",
    "exception_logger",
    "time_logger",
    "Event",
    "record_event",
    "recent_events",
    "put_metric",
    "get_metrics",
    "nan_check",
    "IterationLogger",
    "LatencyTracker",
    "RatioTracker",
    "annotate",
    "profile_trace",
]
