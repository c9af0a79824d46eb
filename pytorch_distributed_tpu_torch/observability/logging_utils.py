"""Structured logging, events, metrics, the debug level, the NaN check
and per-iteration stats.

Port of ``pytorch_distributed_tpu/observability/logging_utils.py``. The
debug level is read from ``TORCH_DISTRIBUTED_DEBUG`` (torch's switch, which
also turns on the process groups' desync checks at ``DETAIL``) where the
reference reads ``TPU_DISTRIBUTED_DEBUG``; its three values are the same.
:func:`nan_check` scans tensors on any device (a card tensor is reduced
on the card, and one flag crosses to the host).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import torch

logger = logging.getLogger("pytorch_distributed_tpu_torch")

__all__ = [
    "DebugLevel",
    "debug_level",
    "exception_logger",
    "time_logger",
    "Event",
    "add_event_handler",
    "record_event",
    "recent_events",
    "put_metric",
    "get_metrics",
    "nan_check",
    "IterationLogger",
    "LatencyTracker",
    "RatioTracker",
]


class DebugLevel(Enum):
    OFF = "OFF"
    INFO = "INFO"
    DETAIL = "DETAIL"


def debug_level() -> DebugLevel:
    """``TORCH_DISTRIBUTED_DEBUG`` (any case); OFF when unset or unknown."""
    raw = os.environ.get("TORCH_DISTRIBUTED_DEBUG", "OFF").upper()
    try:
        return DebugLevel(raw)
    except ValueError:
        return DebugLevel.OFF


def exception_logger(fn: Callable) -> Callable:
    """Log an exception of a public distributed API with its call's
    shape (torch ``c10d_logger``'s decorator), and re-raise it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            logger.exception("distributed API %s failed (args=%d, kwargs=%s)",
                             fn.__qualname__, len(args), sorted(kwargs))
            raise

    return wrapper


def time_logger(fn: Callable) -> Callable:
    """Log the wall time of a public distributed API at INFO, unless the
    debug level is OFF."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if debug_level() is DebugLevel.OFF:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        logger.info("%s took %.3f ms", fn.__qualname__,
                    (time.perf_counter() - t0) * 1e3)
        return out

    return wrapper


@dataclasses.dataclass
class Event:
    name: str
    source: str = "agent"
    metadata: Optional[Dict[str, Any]] = None
    timestamp: float = 0.0

    def serialize(self) -> str:
        return json.dumps(dataclasses.asdict(self))


_event_handlers: List[Callable[[Event], None]] = []
_recorded_events: List[Event] = []


def add_event_handler(handler: Callable[[Event], None]) -> None:
    """Call ``handler(event)`` at every :func:`record_event` from now on (a
    failing handler is logged, never raised)."""
    _event_handlers.append(handler)


def record_event(name: str, source: str = "agent", **metadata) -> Event:
    ev = Event(name=name, source=source, metadata=metadata or None,
               timestamp=time.time())
    _recorded_events.append(ev)
    if len(_recorded_events) > 10_000:
        del _recorded_events[:5_000]
    for h in _event_handlers:
        try:
            h(ev)
        except Exception:
            logger.exception("event handler failed for %s", name)
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


def _leaves(tree, path=()):
    """``(path, leaf)`` in ``jax.tree_util``'s order and key names: dict
    keys sorted, sequence items as ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def nan_check(tree, *, name: str = "tensor") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (a
    tensor, or nested dicts, lists and tuples of tensors and arrays, on
    any device) that holds a NaN or an Inf; integer leaves are skipped.
    The host-side check of a collective's payload or a checkpoint's (the
    training step reports non-finiteness through the loss scaler)."""
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() or t.is_complex():
            if not bool(torch.isfinite(t).all()):
                key = "/".join(path)
                raise FloatingPointError(f"non-finite values in {name}[{key}]")


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
