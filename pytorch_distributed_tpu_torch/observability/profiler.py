"""Profiler integration on ``torch.profiler``.

Port of ``pytorch_distributed_tpu/observability/profiler.py``, where
``jax.profiler`` writes XPlane traces: here ``torch.profiler`` writes a
Chrome trace (``tensorboard_trace_handler``'s ``*.pt.trace.json``, with
the card's kernels through CUPTI when there is a card), named regions are
``record_function`` ranges (and NVTX ranges on the card), and the same
analyses read the trace back:

* :func:`profile_trace` captures a block into ``log_dir``;
* :func:`annotate` names a region (the eager process group wraps each
  collective in ``pg::<op>[<group>]``);
* :func:`trace_op_breakdown` sums the newest trace's device kernels
  (category ``kernel``), or on the CPU, which has no device line, its
  outermost op and region events;
* :func:`memory_breakdown` measures a call's memory;
* :class:`StepProfiler` traces N steps after a warm-up and summarizes
  them.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "profile_trace",
    "annotate",
    "trace_op_breakdown",
    "memory_breakdown",
    "StepProfiler",
]


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profiler(log_dir: str, schedule=None):
    from torch.profiler import profile, tensorboard_trace_handler

    return profile(activities=_activities(), schedule=schedule,
                   on_trace_ready=tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator:
    """Trace the block into ``log_dir`` (a ``*.pt.trace.json`` Chrome
    trace, the card's activity included when there is a card); yields the
    ``torch.profiler.profile``. Read it with :func:`trace_op_breakdown`,
    TensorBoard or Perfetto."""
    with _profiler(log_dir) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region: a ``record_function`` range in torch.profiler's
    traces, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _newest_trace(log_dir: str) -> dict:
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json*"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _outermost(events: List[dict]) -> List[dict]:
    """The events no other event of the same thread encloses."""
    out, end = [], {}
    for e in sorted(events, key=lambda e: (e["pid"], e["tid"], e["ts"],
                                           -e["dur"])):
        key = (e["pid"], e["tid"])
        if e["ts"] >= end.get(key, float("-inf")):
            out.append(e)
            end[key] = e["ts"] + e["dur"]
    return out


def trace_op_breakdown(log_dir: str, *, top: int = 20) -> Dict:
    """Time by op in the newest trace under ``log_dir``: the device
    kernels (category ``kernel``, graph replays' included) where the trace
    has any, else (the CPU) the outermost op and region events of each
    thread, so nothing is counted twice (the profiler's ``ProfilerStep#n``
    step envelopes are no ops).

    Returns the reference's ``{total_ms, by_type_ms: {type: ms},
    top_ops_ms: [(ms, name)]}`` (a type is a name without a trailing
    ``.<n>``), and ``calls``: the events by name.
    """
    events = [e for e in _newest_trace(log_dir)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e
              and not e["name"].startswith("ProfilerStep#")]  # envelopes
    chosen = [e for e in events if e.get("cat") == "kernel"]
    if not chosen:
        chosen = _outermost([e for e in events if e.get("cat") in (
            "cpu_op", "user_annotation")])
    dur: collections.Counter = collections.Counter()
    by_type: collections.Counter = collections.Counter()
    calls: collections.Counter = collections.Counter()
    for e in chosen:
        name = e["name"]
        dur[name] += e["dur"]
        calls[name] += 1
        by_type[re.sub(r"\.\d+$", "", name)] += e["dur"]
    return {
        "total_ms": round(sum(dur.values()) / 1e3, 3),
        "by_type_ms": {k: round(v / 1e3, 3)
                       for k, v in by_type.most_common(top)},
        "top_ops_ms": [(round(v / 1e3, 3), k)
                       for k, v in dur.most_common(top)],
        "calls": dict(calls),
    }


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _cpu_peak(prof) -> int:
    """The most the CPU allocator held above its level at the profiler's
    start, from the trace's memory events."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    level = peak = 0
    for e in sorted((e for e in events if e.get("name") == "[memory]"
                     and e.get("args", {}).get("Device Type") == 0),
                    key=lambda e: e["ts"]):
        level += e["args"]["Bytes"]
        peak = max(peak, level)
    return peak


def memory_breakdown(fn, *args, **kwargs) -> Dict:
    """The memory of one call ``fn(*args, **kwargs)``, in bytes: the
    counterpart of the reference's compiled-program memory analysis, but
    measured while the call runs, where JAX's is read off the compiled
    program without running it.

    * ``argument_size``: the tensor arguments (nested in lists, tuples and
      dicts too), exactly;
    * ``output_size``: the tensors it returns;
    * ``temp_size``: the most the allocator held above what was resident
      at the call (the arguments among it) while it ran, new outputs
      included: the card's allocator peak, or on the CPU the running sum
      of torch.profiler's memory events;
    * ``alias_size``: the outputs that share storage with an argument.
    """
    arg_ts = _tensors((args, kwargs))
    device = arg_ts[0].device if arg_ts else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(device)
        temp = torch.cuda.max_memory_allocated(device) - base
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            out = fn(*args, **kwargs)
        temp = _cpu_peak(prof)
    out_ts = _tensors(out)
    storages = {t.untyped_storage().data_ptr() for t in arg_ts}
    return {
        "argument_size": _nbytes(arg_ts),
        "output_size": _nbytes(out_ts),
        "temp_size": int(temp),
        "alias_size": _nbytes(t for t in out_ts
                              if t.untyped_storage().data_ptr() in storages),
    }


#: idle host time at each edge of a capture on the card (``StepProfiler``)
_FENCE_S = 0.05


class StepProfiler:
    """Trace ``n_steps`` training steps after ``warmup`` and summarize
    them (:func:`trace_op_breakdown` plus ``steps_captured``)::

        sp = StepProfiler("/tmp/prof", n_steps=5, warmup=2)
        for batch in loader:
            with sp.step():
                state, m = trainer.step(state, batch)
        print(sp.summary())   # once n_steps were captured

    The trace records steps ``warmup + 1`` to ``warmup + n_steps``, and
    stops after them, or at once when a step raises (a profiler session
    must not be left running). The profiler starts one step early, in its
    warm-up state, during the last warm-up step: turning the device
    tracing on takes that long, and a trace started cold loses the first
    step's first kernels. Where the card is in use, each edge of the
    recorded window synchronizes it and waits ``_FENCE_S`` of idle host
    time: a kernel's timestamp can fall milliseconds before its launch on
    the host clock, and the profiler drops device records outside its
    window.
    """

    def __init__(self, log_dir: str, *, n_steps: int = 5, warmup: int = 2):
        self.log_dir = log_dir
        self.n_steps = n_steps
        self.warmup = warmup
        self._seen = 0
        self._captured = 0
        self._prof = None
        self._summary: Optional[Dict] = None

    @staticmethod
    def _edge(prof=None) -> None:
        """Synchronize the card, move ``prof`` on to its next state (the
        window's start), and wait ``_FENCE_S``."""
        card = torch.cuda.is_available() and torch.cuda.is_initialized()
        if card:
            torch.cuda.synchronize()
        if prof is not None:
            prof.step()
        if card:
            time.sleep(_FENCE_S)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        from torch.profiler import schedule

        self._seen += 1
        if (self._seen == max(self.warmup, 1) and self._summary is None
                and self._prof is None):
            # the last warm-up step runs under the profiler's warm-up
            self._prof = _profiler(self.log_dir, schedule(
                wait=0, warmup=1, active=self.n_steps, repeat=1)
                if self.warmup else None)
            self._prof.start()
            if not self.warmup:
                self._edge()
        try:
            yield
        except BaseException:
            self.close()
            raise
        else:
            if self._prof is None:
                return
            if self._seen == self.warmup:
                self._edge(self._prof)      # recording from the next step
            elif self._seen > self.warmup:
                self._captured += 1
                if self._captured >= self.n_steps:
                    self.close()

    def close(self) -> None:
        """Stop a live capture and summarize it. Idempotent; called when
        ``n_steps`` were captured or a step raised: call it when the loop
        may end early."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._edge()
        try:
            prof.stop()
        except Exception:
            return
        try:   # the analysis never breaks the training loop
            bd = trace_op_breakdown(self.log_dir)
            bd["steps_captured"] = self._captured
            self._summary = bd
        except Exception as e:
            self._summary = {
                "error": f"trace analysis failed: {type(e).__name__}",
                "steps_captured": self._captured}

    def summary(self) -> Optional[Dict]:
        self.close()
        return self._summary
