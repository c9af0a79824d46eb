"""The device trace of a few replayed steps, and what is read from it.

``record`` runs the steps under ``torch.profiler`` (CUPTI: every kernel of
a CUDA graph replay is listed) and keeps two lists of ``(name, start_ns,
end_ns)``: the device's operations (kernels, copies, fills) and the host's
operations. The rest are plain functions over those lists, so that the
CPU tests can feed them a synthetic trace. The traced window runs from the
first device operation's start to the last one's end: the profiler drops
device records that fall outside its window on the host clock, so the
edges are taken from the device's own records.
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Span = Tuple[str, int, int]


@dataclass
class Trace:
    device_ops: List[Span]
    host_ops: List[Span] = field(default_factory=list)


def _ns(event, what: str) -> int:
    get = getattr(event, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(event, f"{what}_us")() * 1000)


def record(run: Callable[[], None]) -> Trace:
    """Profile ``run`` (which runs the steps and waits for them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        run()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        span = (e.name(), start, start + _ns(e, "duration"))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span)
    return Trace(device, host)


def union(spans: Sequence[Span]) -> List[Tuple[int, int]]:
    """The merged intervals covered by ``spans``."""
    out: List[List[int]] = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def busy_window(trace: Trace) -> Optional[Tuple[float, float]]:
    """``(busy_s, window_s)``: the seconds in which a device operation ran
    and the traced window's length; None without device operations."""
    merged = union(trace.device_ops)
    if not merged:
        return None
    return _length(merged) / 1e9, (merged[-1][1] - merged[0][0]) / 1e9


def idle_percent(trace: Trace) -> Optional[float]:
    """The traced window's share, in percent, in which no device operation
    ran; None without device operations."""
    bw = busy_window(trace)
    if bw is None or bw[1] <= 0:
        return None
    return 100.0 * (1.0 - bw[0] / bw[1])


def classify(name: str, families: Dict[str, List[str]]) -> Optional[str]:
    """The family one of whose patterns matches ``name`` (``re.search``),
    or None. A name that two families match is an error: a family file
    added later must not take kernels from an existing metric."""
    found = [f for f in sorted(families)
             if any(re.search(p, name) for p in families[f])]
    if len(found) > 1:
        raise ValueError(f"kernel {name!r} matches the families {found}")
    return found[0] if found else None


def family_spans(trace: Trace, families: Dict[str, List[str]],
                 family: str) -> List[Span]:
    return [op for op in trace.device_ops
            if classify(op[0], families) == family]


def family_seconds(trace: Trace, families: Dict[str, List[str]],
                   family: str) -> float:
    """Device seconds of the operations of ``family`` (summed)."""
    return sum(e - s for _, s, e in family_spans(trace, families,
                                                  family)) / 1e9


def _subtract(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the merged intervals ``a`` outside the merged ``b``."""
    total, j = 0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total


def exposed_seconds(trace: Trace, families: Dict[str, List[str]],
                    family: str) -> float:
    """Seconds in which an operation of ``family`` runs and no operation
    of another family (or of none) does."""
    mine = family_spans(trace, families, family)
    others = [op for op in trace.device_ops
              if classify(op[0], families) != family]
    return _subtract(union(mine), union(others)) / 1e9


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(trace: Trace, top: int = 10, labelled: int = 200) -> Dict:
    """The device operations that took the most time (summed by name),
    and the idle gaps between them summed by the host operation that was
    running at each gap's middle (the innermost one; the ``labelled``
    longest gaps are labelled, the rest summed under one label that says
    how many they are and how long the longest of them is)."""
    by_name: Dict[str, int] = collections.Counter()
    for name, s, e in trace.device_ops:
        by_name[name] += e - s
    device_ops = [[_short(n), t / 1e9] for n, t in by_name.most_common(top)]
    merged = union(trace.device_ops)
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])
    labels: Dict[str, int] = collections.Counter()
    host = sorted(trace.host_ops, key=lambda x: x[1])
    for s, e in gaps[:labelled]:
        mid = (s + e) // 2
        around = [h for h in host if h[1] <= mid <= h[2]]
        label = (min(around, key=lambda h: h[2] - h[1])[0] if around
                 else "no host operation")
        labels[_short(label)] += e - s
    rest = gaps[labelled:]
    if rest:
        longest = (rest[0][1] - rest[0][0]) / 1e3
        labels[f"{len(rest)} shorter gaps, each at most {longest:.1f} us"] += sum(
            e - s for s, e in rest)
    idle = [[n, t / 1e9] for n, t in labels.most_common(top)]
    return {"device_ops": device_ops, "idle_gaps": idle}
