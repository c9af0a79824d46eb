"""Metrics and events: latency percentiles, ratio counters, a process-wide
metric table, a bounded structured-event log and per-iteration training
stats.

Minimal copies of what the scheduler and the ResNet entry point use from
``pytorch_distributed_tpu/observability/logging_utils.py``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

logger = logging.getLogger("pytorch_distributed_tpu_torch")

__all__ = [
    "Event",
    "IterationLogger",
    "LatencyTracker",
    "RatioTracker",
    "get_metrics",
    "put_metric",
    "recent_events",
    "record_event",
]


@dataclasses.dataclass
class Event:
    name: str
    source: str = "agent"
    metadata: Optional[Dict[str, Any]] = None
    timestamp: float = 0.0

    def serialize(self) -> str:
        return json.dumps(dataclasses.asdict(self))


_recorded_events: List[Event] = []


def record_event(name: str, source: str = "agent", **metadata) -> Event:
    ev = Event(name=name, source=source, metadata=metadata or None,
               timestamp=time.time())
    _recorded_events.append(ev)
    if len(_recorded_events) > 10_000:
        del _recorded_events[:5_000]
    logger.debug("event: %s", ev.serialize())
    return ev


def recent_events(n: int = 100) -> List[Event]:
    return _recorded_events[-n:]


_metrics: Dict[str, float] = defaultdict(float)
_metrics_lock = threading.Lock()


def put_metric(name: str, value: float = 1.0) -> None:
    with _metrics_lock:
        _metrics[name] += value


def get_metrics() -> Dict[str, float]:
    return dict(_metrics)


class LatencyTracker:
    """Streaming latency samples with nearest-rank percentile summaries;
    keeps the most recent ``max_samples``."""

    def __init__(self, max_samples: int = 100_000):
        self.max_samples = max(1, max_samples)
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self._samples.append(seconds)
        if len(self._samples) > self.max_samples:
            del self._samples[: self.max_samples // 2]

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, ``q`` in [0, 100]. 0.0 when empty."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        rank = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[rank]

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean_s": self.mean(),
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "max_s": max(self._samples) if self._samples else 0.0,
        }


class RatioTracker:
    """Streaming numerator / denominator counter."""

    def __init__(self):
        self.num = 0.0
        self.den = 0.0

    def add(self, num: float, den: float = 1.0) -> None:
        self.num += num
        self.den += den

    def rate(self, default: float = 0.0) -> float:
        return self.num / self.den if self.den else default


class IterationLogger:
    """Per-iteration timing stats, one sample every ``sample_rate``
    iterations (torch DDP's ``Logger``). A sample's ``step_time_s`` is the
    host time from ``start_iteration`` to ``end_iteration``; it covers the
    device work only if the caller waited for it (read a value of the step,
    or synchronize) before ``end_iteration``."""

    def __init__(self, sample_rate: int = 1):
        self.sample_rate = max(1, sample_rate)
        self.iterations = 0
        self.samples: List[Dict[str, float]] = []
        self._t_start: Optional[float] = None

    def start_iteration(self) -> None:
        self._t_start = time.perf_counter()

    def end_iteration(self, **extra: float) -> None:
        self.iterations += 1
        if self._t_start is None:
            return
        if self.iterations % self.sample_rate == 0:
            self.samples.append({
                "iteration": self.iterations,
                "step_time_s": time.perf_counter() - self._t_start,
                **extra,
            })
            if len(self.samples) > 10_000:
                del self.samples[:5_000]
        self._t_start = None

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"iterations": self.iterations}
        times = [s["step_time_s"] for s in self.samples]
        return {
            "iterations": self.iterations,
            "avg_step_time_s": sum(times) / len(times),
            "max_step_time_s": max(times),
            "min_step_time_s": min(times),
        }
