"""One program per step: a step body captured once as a CUDA graph and
replayed, the port's counterpart of ``jax.jit``.

The JAX package jits its serving steps and its pipelined train step and
donates the state they update, so each step is one program. Here a step
body is a function of no arguments that reads static input buffers, updates
its state tensors in place and returns its outputs. On a CUDA device
:class:`Program` captures one call of the body into a
``torch.cuda.CUDAGraph`` on a side stream, over a memory pool that the
caller's programs share, and every call replays it on the current stream:
the captured tensors keep their addresses, so the outputs are the same
tensors after every replay. The caller warms the body up first, eagerly on
that side stream (``warm_stream``), so that cuBLAS's handles and
workspaces, lazily loaded kernels, cuDNN's algorithm search and the
first-use ``nvcc`` build of the port's kernels all exist before the
capture. On the CPU every call runs the body: the same code on the same
buffers, eagerly. A capture that fails raises; nothing falls back to the
eager body.

Generators the body draws from are registered with the graph: a replay
reads the generator's seed and offset and advances the offset by what the
captured draws used, as the eager calls would.

The kernels' launch counters (``ops.paged_attention.launches`` and
``ops.flash_attention.launches``) count their wrappers' launches; a capture
counts the launches it records and a replay, which calls no wrapper,
counts none. What a replay ran on the card is read from a device trace
(``torch.profiler``), which lists the replayed kernels.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

__all__ = ["Program", "warm_stream"]


def warm_stream(device: torch.device) -> torch.cuda.Stream:
    """A side stream for warm-ups and captures, ordered after the work
    queued so far on the current stream."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    return side


class Program:
    """A step body run as one CUDA graph replay per call on the card, and
    eagerly on the CPU.

    Args:
      body: ``() -> outputs`` (a tensor or a tuple of tensors); reads static
        inputs and updates state in place.
      device: where the body's tensors live.
      pool: a ``torch.cuda.graph_pool_handle()`` shared with the caller's
        other programs (replayed one at a time, on one stream); None gives
        the program a pool of its own.
      generators: the ``torch.Generator``s the body draws from.
      stream: the side stream to capture on: the one the caller warmed
        the body up on (``warm_stream``).
      capture: False runs the body eagerly on the card too (a body whose
        collectives cannot be captured: a gloo group's).

    ``replays`` counts the replays and ``capture_s`` is the capture's host
    time.
    """

    def __init__(self, body: Callable, *, device: torch.device, pool=None,
                 generators: Sequence[torch.Generator] = (),
                 stream: Optional[torch.cuda.Stream] = None,
                 capture: bool = True):
        self.body = body
        self.replays = 0
        self.outputs = None
        self.capture_s = 0.0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type == "cuda" and capture:
            self._capture(stream, pool, tuple(generators))

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _capture(self, side, pool, generators) -> None:
        t0 = time.perf_counter()
        saved = [g.get_state() for g in generators]
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            # thread_local: a loader's pin-memory thread may call the CUDA
            # runtime meanwhile; only this thread's calls are captured
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = self.body()
        finally:
            for g, state in zip(generators, saved):
                g.set_state(state)
        self.outputs = outputs
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        if self._graph is None:
            return self.body()
        self._graph.replay()
        self.replays += 1
        return self.outputs
