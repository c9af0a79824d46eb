"""Spans inside the captured step: device marks that every replay runs.

The runner captures the whole train step as one CUDA graph
(``pipeline_exec.AsyncRunner``), and a replay keeps none of the step's host
regions: ``annotate``'s ranges, ``record_function`` and the process group's
``pg::`` ranges run once, at capture. A span here is bounded by two marks
that are kernels (``ops/csrc/spans.cu``: ``ptd_span_<name>_begin`` stores
the device's ``%globaltimer``, ``ptd_span_<name>_end`` adds the time since
to the span's fp32 accumulator, in ms), so a capture records them as graph
nodes in stream order with the work they bound, and:

  * a device trace names each boundary by the kernel's symbol, on the
    trace's own clock (the benchmark's ``portbench/spans.py`` reads them);
  * the accumulators are the program's own reading of the same
    boundaries: the runner zeroes them at the start of its step body and
    pushes them into its ``MetricRing`` as ``span_ms.<name>`` (the ms a
    step, summed over the span's occurrences), with no profiler and no
    extra sync.

On the CPU a mark adds ``time.perf_counter_ns`` differences into the same
accumulators, so everything but the kernel runs in the CPU tests.

Marks are issued only while a :class:`SpanClock` is active (the runner's,
around its step body): a plain ``Trainer.step``, an eval step or a serving
step marks nothing.

Where each span sits (``SPANS``, the same list as ``spans.cu``'s
``PTD_SPANS``, in order):

  * ``forward``, ``backward``, ``grad_exchange``, ``update``: the phases of
    ``Trainer.step_body``, which partition it (placement to the loss; the
    ``.backward()`` call; the strategy's gradient reduction, a hook or
    ``shard_grads``; unscale, norm, clip and the optimizer's step);
  * ``lm_head``: GPT-2's tied head (``models.gpt2.tied_head``) and the
    chunked loss that applies it itself (``ops.chunked_xent``), forward
    and backward;
  * ``lm_loss``: the fp32 logits' cast and the cross-entropy over them
    (``trainer.lm_loss``), forward and backward;
  * ``bn_group``: BatchNorm over a stats group (``models.resnet``, the
    group's all-reduced sums), forward and backward.

A backward boundary comes from :func:`enter` and :func:`leave`: identity
``autograd.Function``s whose backward marks the span's end and begin.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import time
from typing import Dict, Iterator

import torch

__all__ = ["SPANS", "SpanClock", "begin", "end", "enter", "leave"]

#: the span names, in ``spans.cu``'s ``PTD_SPANS`` order
SPANS = ("forward", "backward", "grad_exchange", "update", "lm_head",
         "lm_loss", "bn_group")
_INDEX = {name: i for i, name in enumerate(SPANS)}

_active: contextvars.ContextVar = contextvars.ContextVar("ptd_span_clock",
                                                         default=None)


def _kernel_lib() -> ctypes.CDLL:
    from pytorch_distributed_tpu_torch.ops import _build

    lib = _build.load("spans")
    if lib.ptd_span_mark.argtypes is None:
        lib.ptd_span_mark.argtypes = (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p)
        lib.ptd_span_mark.restype = ctypes.c_int
    return lib


class SpanClock:
    """The accumulators of one program's spans, on ``device``.

    ``acc`` is ``[len(SPANS)]`` fp32, the ms each span took since the last
    :meth:`zero`; ``seen`` the spans marked at least once (on the host, so
    a capture's marks count).
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.acc = torch.zeros(len(SPANS), dtype=torch.float32,
                               device=self.device)
        self._cuda = self.device.type == "cuda"
        # the open spans' begin times: device slots the kernels write, or
        # host integers on the CPU
        self._t0 = (torch.zeros(len(SPANS), dtype=torch.int64,
                                device=self.device)
                    if self._cuda else [0] * len(SPANS))
        self._lib = _kernel_lib() if self._cuda else None
        self.seen: set = set()

    def mark(self, name: str, is_end: bool) -> None:
        """Mark span ``name``'s begin or end on the current stream."""
        i = _INDEX[name]
        self.seen.add(name)
        if self._cuda:
            rc = self._lib.ptd_span_mark(
                i, int(is_end), self._t0.data_ptr(), self.acc.data_ptr(),
                torch.cuda.current_stream(self.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"span mark {name} failed to launch "
                                   f"(cudaError {rc})")
            return
        now = time.perf_counter_ns()
        if is_end:
            self.acc[i] += (now - self._t0[i]) / 1e6
        else:
            self._t0[i] = now

    def zero(self) -> None:
        """Empty the accumulators in place (one fill)."""
        self.acc.zero_()

    def readings(self) -> Dict[str, torch.Tensor]:
        """``span_ms.<name>``: 0-d views of the accumulators of the spans
        seen."""
        return {f"span_ms.{n}": self.acc[_INDEX[n]] for n in SPANS
                if n in self.seen}

    @contextlib.contextmanager
    def active(self) -> Iterator["SpanClock"]:
        """Marks issued inside the block (on this thread, and the backward
        marks of the edges it made) go to this clock."""
        token = _active.set(self)
        try:
            yield self
        finally:
            _active.reset(token)


def begin(name: str) -> None:
    clock = _active.get()
    if clock is not None:
        clock.mark(name, False)


def end(name: str) -> None:
    clock = _active.get()
    if clock is not None:
        clock.mark(name, True)


class _Edge(torch.autograd.Function):
    """The identity on ``tensors`` that marks span ``name`` as it runs
    (its end where ``fwd_end``, else its begin), and the other edge as
    the gradients pass back through it."""

    @staticmethod
    def forward(ctx, clock, name, fwd_end, *tensors):
        ctx.set_materialize_grads(False)
        ctx.clock, ctx.name, ctx.bwd_end = clock, name, not fwd_end
        clock.mark(name, fwd_end)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # the autograd engine's thread: the clock is the one the forward saw
        ctx.clock.mark(ctx.name, ctx.bwd_end)
        return (None, None, None, *grads)


def _edge(name: str, fwd_end: bool, tensors):
    clock = _active.get()
    if clock is None:
        out = tensors
    else:
        out = _Edge.apply(clock, name, fwd_end, *tensors)
    return out[0] if len(out) == 1 else out


def enter(name: str, *tensors: torch.Tensor):
    """``tensors`` unchanged (one tensor, or a tuple), with span ``name``
    begun here in the forward and ended here in the backward (once the
    gradients of all of them arrived)."""
    return _edge(name, False, tensors)


def leave(name: str, *tensors: torch.Tensor):
    """``tensors`` unchanged, with span ``name`` ended here in the forward
    and begun here in the backward."""
    return _edge(name, True, tensors)
