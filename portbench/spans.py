"""The program's span marks in a device trace.

The port marks the boundaries of its step's phases and of a few layers
with tiny kernels (``observability/spans.py`` and ``ops/csrc/spans.cu`` of
``pytorch_distributed_tpu_torch``): ``ptd_span_<name>_begin`` and
``ptd_span_<name>_end``, one pair each time the span runs, captured into
the step's CUDA graph so that every replay runs them. A span's device time
is read here as the time from each begin kernel's end to the matching end
kernel's start, on the trace's own clock.

A program that has no marks (a commit before them) gives no pairs, and a
reader returns None: the metric is left out of the line.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from portbench.trace import Span, Trace

_MARK = re.compile(r"ptd_span_(\w+?)_(begin|end)\b")


def pairs(trace: Trace, name: str) -> Optional[List[Tuple[Span, Span]]]:
    """``(begin, end)`` of each occurrence of span ``name``, in trace
    order; None where there is none, or the begins and ends do not
    alternate begin, end, begin, ... (a trace clipped inside a span)."""
    marks = []
    for op in trace.device_ops:
        m = _MARK.search(op[0])
        if m and m.group(1) == name:
            marks.append((op[1], m.group(2), op))
    marks.sort(key=lambda x: x[0])
    kinds = [k for _, k, _ in marks]
    if not marks or kinds != ["begin", "end"] * (len(marks) // 2):
        return None
    ops = [op for _, _, op in marks]
    return list(zip(ops[::2], ops[1::2]))


def ms_per_step(trace: Trace, names: Sequence[str],
                steps: int) -> Optional[float]:
    """Device ms a step inside the spans ``names`` (summed over them and
    over their occurrences): from each begin's end to its end's start.
    None unless every name has whole pairs, as many for every traced step
    (a number of pairs that ``steps`` divides)."""
    if not steps:
        return None
    total = 0
    for name in names:
        found = pairs(trace, name)
        if found is None or len(found) % steps:
            return None
        total += sum(end[1] - begin[2] for begin, end in found)
    return total / 1e6 / steps
