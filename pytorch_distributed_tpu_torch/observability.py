"""Serving metrics and events: latency percentiles, ratio counters, a
process-wide metric table and a bounded structured-event log.

Minimal copies of what the scheduler uses from
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
