"""AsyncRunner: the K-deep pipelined train-step executor.

Port of ``pytorch_distributed_tpu/pipeline_exec/runner.py``. The JAX
runner composes the trainer's step with :meth:`MetricRing.push` into one
donated jitted program. Here the step body is ``Trainer.step`` itself over
static input buffers, followed by the ring push and the write-back of the
new loss-scaler state into the tensors the next step reads; on the card it
is captured once as a CUDA graph (``_graphs.Program``) and every
:meth:`AsyncRunner.submit` is one replay, on the CPU it runs eagerly:

  * **inputs** -- ``submit`` copies the batch (numpy arrays or tensors)
    into the static buffers on the current stream, where the replay runs
    too, so a copy never overtakes the replay that still reads the
    buffers. A batch from ``data.loader.prefetch_to_device`` was copied on
    its side stream, which the current stream waits for (and its tensors
    are marked as used there) before the batch is handed over.
  * **fence** -- a CUDA event after each replay; the host blocks only on
    the one ``depth`` steps behind, so at most ``depth`` steps are in
    flight and the current step is never waited on;
  * **drain** -- every ``drain_every`` steps a non-blocking copy of the
    ring into pinned host memory is queued behind the replay that filled
    it and before the next one overwrites it; the values are read at
    :meth:`AsyncRunner.finish`, the only full sync.

The body also zeroes the runner's span accumulators (one fill, see
``observability.spans``), runs the step with its ``SpanClock`` active,
and pushes each span's ms beside the step's metrics as
``span_ms.<name>``: the phases of
``Trainer.step_body`` and the model's marked layers, read from marks that
every replay runs, with no profiler.

Before the capture, :meth:`AsyncRunner.start` runs ``warmup_steps`` eager
steps on the capture stream (cuDNN's algorithm search, cuBLAS, the first
build of the port's kernels) and then puts back every tensor they changed:
the parameters (FSDP's shards among them), the model's buffers, the
tensors the optimizer steps on (ZeRO1's blocks), the optimizer state, the
scaler state, the ring and the dropout generators' states. So the
runner's steps are the steps sequential ``Trainer.step`` calls would take.
The dropout generators (``Trainer.generators``) are registered with the
program, and before each replay the host sets them for the step
(``Trainer.seed_dropout``: the card's Philox offset, which a replay
reads), so a replay draws the masks an eager step draws. On the card, Adam's parameter groups are
made ``capturable`` (their step counts move to the card), which graph
capture requires.

Under a sharded strategy the step's collectives (``parallel.comm``: the
gradient reduce-scatters and all-reduces, the parameter gathers, the
norm's all-reduce) are captured with it: each is a synchronous NCCL call
on the capture stream (the process group is made with
``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``, ``distributed.init_process_group``),
so a replay runs them in place. ``sharded_update`` reports whether the
step takes the sharded update, as the reference's runner does.

A gradient communication hook's collectives are captured the same way,
and a stateful hook's state (``TrainState.comm_state``: PowerSGD's Q and
error buffers, updated in place) is a step tensor like the optimizer's.
Where the step's program depends on the step count (PowerSGD's warm-up
before ``start_iter``, a ``lax.cond`` in the reference), the runner keys
its programs on ``Trainer.program_key(step)``: each key's program is
warmed up and captured when the first step that needs it is submitted,
so a run across ``start_iter`` captures two programs, and neither warm-up
runs the other's branch. The programs share one memory pool and replay
in the order they were captured.

The audit surface (the reference's ``executable_count`` and
``step_artifacts``, read by ``analysis.ir``): ``executable_count`` is the
number of ``Program`` objects the runner has built, 1 after any number of
same-shape submits; ``step_artifacts`` returns the step's ``Program`` and
the collectives (``parallel.comm``'s record) its capture recorded, or on
the CPU those of the last warm-up step, which a call of the eager body
repeats.

Whether the step is captured is decided when the runner is built, from
the trainer (``Trainer.graph_capturable``), never after a failed capture:
a pipeline whose stages talk over gloo (ranks sharing a card) runs its
body eagerly on the card, one body a submit; a pipeline on NCCL is
captured. Only pp 1 (one card) has been captured and measured, as one
replay a step; a captured step at pp > 1 is unverified (ROADMAP C).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from pytorch_distributed_tpu_torch._graphs import Program, warm_stream
from pytorch_distributed_tpu_torch.observability import record_event, spans
from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.pipeline_exec.metric_ring import MetricRing

__all__ = ["AsyncRunner", "MetricHistory"]


class MetricHistory:
    """Per-step metric series drained from the device ring: step ``i`` of
    ``history[name]`` is the scalar ``Trainer.step`` would have returned
    for that step."""

    def __init__(self, series: Dict[str, np.ndarray]):
        self.series = series

    def __getitem__(self, name: str) -> np.ndarray:
        return self.series[name]

    def __contains__(self, name: str) -> bool:
        return name in self.series

    def keys(self):
        return self.series.keys()

    @property
    def n_steps(self) -> int:
        if not self.series:
            return 0
        return len(next(iter(self.series.values())))

    def first(self, name: str = "loss") -> float:
        return float(self.series[name][0])

    def last(self, name: str = "loss") -> float:
        return float(self.series[name][-1])


def _make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Adam/AdamW under graph capture: ``capturable`` groups, step counts
    on the parameters' device."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in optimizer.param_groups:
        group["capturable"] = True
    for p, st in optimizer.state.items():
        if "step" in st and st["step"].device != p.device:
            st["step"] = st["step"].to(p.device)


def _named_step_tensors(trainer, state) -> list:
    """``(path, tensor)`` of every tensor a step changes: the parameters
    (``param.<name>``), the model's buffers (``buffer.<name>``), the
    tensors the optimizer steps on where they are not parameters (the
    blocks of ZeRO1's sharded update, ``block.<name>``), the optimizer
    state (``opt.<name>.<key>``), the scaler state (``scaler.<field>``)
    and a stateful hook's state (``comm_state<keys>``)."""
    model, opt = trainer.model, trainer.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    layout = getattr(trainer, "layout", None)
    if layout is not None:
        names.update({id(leaf.tensor): leaf.name for leaf in layout.leaves})
    out = ([(f"param.{n}", p) for n, p in model.named_parameters()]
           + [(f"buffer.{n}", b) for n, b in model.named_buffers()])
    seen = {id(t) for _, t in out}
    out += [(f"block.{names.get(id(p), '?')}", p)
            for group in opt.param_groups for p in group["params"]
            if id(p) not in seen]
    for p, st in opt.state.items():
        for k, v in st.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"optimizer state {k!r} is not a tensor: the runner "
                    "puts back tensor state only")
            out.append((f"opt.{names.get(id(p), '?')}.{k}", v))
    if state.scaler is not None:
        out += [("scaler.scale", state.scaler.scale),
                ("scaler.growth_tracker", state.scaler.growth_tracker)]
    out += _tensor_leaves(state.comm_state, "comm_state")
    return out


def _step_tensors(trainer, state) -> list:
    """Every tensor a step changes (``_named_step_tensors`` without the
    paths)."""
    return [t for _, t in _named_step_tensors(trainer, state)]


def _tensor_leaves(tree, path: str) -> list:
    """``(path, tensor)`` of the tensors of a (nested) dict: a stateful
    hook's comm state."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _tensor_leaves(v, f"{path}[{k!r}]")]
    return []


def _snapshot(trainer, state, extra=()) -> Callable[[], None]:
    """Copies of every tensor a step changes (and of ``extra``); returns
    the function that puts them back in place."""
    opt = trainer.optimizer
    keys = {p: tuple(st) for p, st in opt.state.items() if st}
    tensors = _step_tensors(trainer, state) + list(extra)
    saved = [t.detach().clone() for t in tensors]
    rngs = [(g, g.get_state()) for g in trainer.generators]

    @torch.no_grad()
    def restore() -> None:
        if {p: tuple(st) for p, st in opt.state.items() if st} != keys:
            raise RuntimeError(
                "the warm-up steps created optimizer state: create it "
                "before the runner starts (Trainer.init does for Adam and "
                "SGD)")
        for t, s in zip(tensors, saved):
            t.copy_(s)
        for g, rng in rngs:
            g.set_state(rng)

    return restore


def _metric_names(metrics) -> tuple:
    bad = {k: tuple(getattr(v, "shape", ())) for k, v in metrics.items()
           if not isinstance(v, torch.Tensor) or v.dim() != 0}
    if bad:
        raise ValueError(f"pipelined metric ring holds 0-d tensors only; "
                         f"other metrics: {bad}")
    return tuple(sorted(metrics))


class AsyncRunner:
    """Pipelined executor over a :class:`..trainer.Trainer`.

    Args:
      trainer: the Trainer whose step to drive (its ``init`` already run).
      depth: max steps in flight (K >= 1).
      drain_every: ring size N; the ring is copied to the host (without
        blocking) once per N steps.
    """

    #: eager steps run, and undone, at :meth:`start` before the capture
    warmup_steps = 3
    #: the whole step (placement, forward, backward, gradient reduction,
    #: unscale, clip, optimizer or skip-on-inf, ring push) is one graph
    #: replay on the card
    programs_per_step: float = 1.0

    def __init__(self, trainer, *, depth: int = 2, drain_every: int = 32):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if drain_every < 1:
            raise ValueError(f"drain_every must be >= 1, got {drain_every}")
        self.trainer = trainer
        self.depth = int(depth)
        self.drain_every = int(drain_every)
        self.device = trainer.strategy.device
        #: the step takes the sharded weight update (ZeRO1, FSDP)
        self.sharded_update = bool(getattr(trainer.strategy,
                                           "sharded_update", False))
        #: the step is captured as a CUDA graph (the card, and a trainer
        #: whose step can be: not a pipeline over gloo), else it runs
        #: eagerly; chosen here, once
        self.graphs = (self.device.type == "cuda"
                       and trainer.graph_capturable)
        #: the captured step programs, by ``Trainer.program_key``
        self.programs: Dict = {}
        #: the collectives each program's capture recorded (the CPU: its
        #: last warm-up step's), by key
        self.inventories: Dict = {}
        self._built = 0
        self._key = None
        self._ring = None
        self._clock = None
        self._reset()

    @property
    def _program(self):
        """The program of the first key built (the only one without a
        stateful hook), or None."""
        return next(iter(self.programs.values()), None)

    @property
    def dispatch_count(self) -> int:
        """Step programs run since :meth:`start`: graph replays on the
        card, eager bodies on the CPU."""
        return self._dispatches

    @property
    def executable_count(self) -> int:
        """``Program`` objects built since the runner was made: 1 after any
        number of same-shape submits, one more for each batch shape (a
        ``start`` on another shape rebuilds) and each new program key.
        With :attr:`dispatch_count`, the structural evidence behind
        ``programs_per_step == 1`` (the IR audit's program count)."""
        return self._built

    def _reset(self) -> None:
        self._state = None
        self._n = 0
        self._dispatches = 0
        self._fences: collections.deque = collections.deque()
        self._drains: list = []
        self._started = False

    # -- setup -------------------------------------------------------------
    def _body(self, state, inputs, ring):
        trainer, clock = self.trainer, self._clock

        def body():
            clock.zero()
            with clock.active():
                new_state, metrics = trainer.step_body(state, inputs)
            ring.push({**metrics, **clock.readings()})
            if trainer._scaling:   # the next step reads the new scale
                state.scaler.scale.copy_(new_state.scaler.scale)
                state.scaler.growth_tracker.copy_(
                    new_state.scaler.growth_tracker)
        return body

    def _build(self, state, sample, key) -> None:
        """The program of ``key`` for ``state`` (at the step that first
        needs it): the warm-up (undone), then the capture. The first build
        also makes the static inputs shaped as ``sample``, the ring and the
        programs' memory pool; a later one warms up on the inputs and ring
        as they are and puts the ring back too."""
        device, trainer = self.device, self.trainer
        on_card = device.type == "cuda"
        first = not self.programs
        if first:
            inputs = type(sample)(torch.as_tensor(x).to(device, copy=True)
                                  for x in sample)
            restore = _snapshot(trainer, state)
            self._pool = torch.cuda.graph_pool_handle() if on_card else None
            self._clock = spans.SpanClock(device)
        else:
            inputs, ring = self._inputs, self._ring
            restore = _snapshot(trainer, state, (ring.idx, ring.buf))
        side = warm_stream(device) if on_card else None
        last: list = []   # the collectives of the last warm-up step
        with torch.cuda.stream(side) if on_card else contextlib.nullcontext():
            try:
                warm = self.warmup_steps
                if first:
                    with comm.recording() as last, self._clock.active():
                        _, metrics = trainer.step(state, inputs)
                    names = (_metric_names(metrics)
                             + tuple(self._clock.readings()))
                    ring = MetricRing.create(names, self.drain_every, device)
                    warm -= 1
                body = self._body(state, inputs, ring)
                for _ in range(warm):
                    with comm.recording() as last:
                        body()
            finally:
                restore()
        if on_card:
            torch.cuda.current_stream(device).wait_stream(side)
        if first:
            ring.reset()
            self._inputs, self._ring = inputs, ring
        # a replay runs the captured collectives; the capture runs none
        with comm.recording(counted=False) as captured:
            program = Program(body, device=device, stream=side,
                              pool=self._pool, generators=trainer.generators,
                              capture=self.graphs)
        self.programs[key] = program
        self.inventories[key] = captured if program.captured else last
        self._built += 1

    def start(self, state, sample_batch) -> "AsyncRunner":
        """Bind the runner to ``state`` and build the pipelined step:
        static inputs of ``sample_batch``'s shapes (it is NOT consumed;
        pass it to :meth:`submit` as well), the warm-up and the capture. A
        later ``start`` with the same state tensors (at the same
        addresses), batch shapes and optimizer settings keeps the captured
        step; a tensor that moved (``load_state_dict``, ``.to``) rebuilds
        it. The captured step holds the Python numbers it read (an
        optimizer's learning rate among them): change them between runs,
        not between submits."""
        self._reset()
        if not isinstance(sample_batch, (tuple, list)):
            raise TypeError("a batch is a tuple of arrays or tensors")
        hook = self.trainer.comm_hook
        if (self.device.type == "cuda" and self.trainer.comm_hook_stateful
                and not getattr(hook, "warm_start", True)):
            raise ValueError(
                "the runner replays a stateful comm hook with warm_start "
                "only: a fresh Q every step is drawn on the host")
        if self.device.type == "cuda":
            _make_capturable(self.trainer.optimizer)
        # the program reads and writes the step's tensors at these
        # addresses, and holds the optimizer's numbers (the learning rate,
        # ...) as captured
        key = (tuple((tuple(np.shape(x)), torch.as_tensor(x).dtype)
                     for x in sample_batch),
               tuple(t.data_ptr() for t in _step_tensors(self.trainer, state)),
               repr([{k: v for k, v in g.items() if k != "params"}
                     for g in self.trainer.optimizer.param_groups]))
        if key != self._key:
            self.programs, self.inventories = {}, {}
            self._build(state, sample_batch,
                        self.trainer.program_key(state.step))
            self._key = key
        else:
            self._ring.reset()
        self._state = state
        self._started = True
        return self

    # -- the hot path ------------------------------------------------------
    def submit(self, batch) -> None:
        """Dispatch one step. Never blocks on the step just submitted;
        blocks only on the step ``depth`` behind once the pipeline is
        full. A replay counts the collectives its capture recorded in
        ``parallel.comm``'s counters (an eager body counts its own)."""
        self._check_batch(batch)
        for s, x in zip(self._inputs, batch):
            s.copy_(torch.as_tensor(x), non_blocking=True)
        step = self._state.step + self._n
        key = self._key_at(step)
        self.trainer.seed_dropout(step)
        program = self.programs[key]
        program()
        if program.captured:
            comm.count_replay(self.inventories[key])
        self._n += 1
        self._dispatches += 1
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self._fences.append(done)
            if len(self._fences) > self.depth:
                # backpressure: the step `depth` behind, never this one
                # graftlint: disable-next-line=host-sync-in-hot-loop -- bounded K-deep in-flight window: waits on the step `depth` behind, never the one just queued; without it the host queues steps without bound
                self._fences.popleft().synchronize()
        if self._n % self.drain_every == 0:
            self._drains.append(self._drain())

    def step_artifacts(self, batch):
        """``(program, inventory)`` of the step the next :meth:`submit` of
        a batch shaped as ``batch`` runs: its ``_graphs.Program`` (a CUDA
        graph on the card, the eager body on the CPU) and the collectives
        recorded when it was built (``parallel.comm.Call`` records). Runs no
        step on the bound state: a program not built yet is built, and its
        warm-up undone."""
        self._check_batch(batch)
        key = self._key_at(self._state.step + self._n)
        return self.programs[key], list(self.inventories[key])

    def _check_batch(self, batch) -> None:
        if not self._started:
            raise RuntimeError("AsyncRunner.start(state, batch) first")
        if len(batch) != len(self._inputs) or any(
                tuple(np.shape(x)) != tuple(s.shape)
                for x, s in zip(batch, self._inputs)):
            raise ValueError("batch shapes differ from the started batch's")

    def _key_at(self, step: int):
        """The program key of step ``step``, its program built first where
        it is not yet."""
        key = self.trainer.program_key(step)
        if key not in self.programs:
            self._build(self._state.replace(step=step), None, key)
        return key

    def _drain(self) -> torch.Tensor:
        """The ring's window, copied to the host behind the step that
        filled it (pinned memory, no wait on the card)."""
        if self.device.type != "cuda":
            return self._ring.stacked()
        host = torch.empty(self._ring.buf.shape, dtype=torch.float32,
                           pin_memory=True)
        host.copy_(self._ring.buf, non_blocking=True)
        return host

    def sync(self) -> None:
        """Block until every dispatched step has executed (a barrier
        before a timed region, not a hot-path call)."""
        if self._fences:
            self._fences[-1].synchronize()

    # -- the one sync ------------------------------------------------------
    def finish(self):
        """Block until every step ran, assemble the per-step metric history
        and return ``(final_state, MetricHistory)``. The only full host
        sync the runner performs."""
        if not self._started:
            raise RuntimeError("AsyncRunner.start(state, batch) first")
        t0 = time.perf_counter()
        self.sync()
        names, size = self._ring.names, self.drain_every
        series = {k: np.zeros(self._n, np.float32) for k in names}
        windows = [w.numpy() for w in self._drains]
        rem = self._n % size
        if rem:
            windows.append(self._ring.buf.cpu().numpy()[:, :rem])
        for w, arr in enumerate(windows):
            for i, k in enumerate(names):
                series[k][w * size:w * size + arr.shape[1]] = arr[i]
        record_event(
            "pipeline_exec.step_budget", steps=self._n, depth=self.depth,
            drain_every=size, programs_per_step=self.programs_per_step,
            graph=any(p.captured for p in self.programs.values()),
            programs=len(self.programs), drains_issued=len(self._drains),
            sharded_update=self.sharded_update,
            finish_block_ms=round((time.perf_counter() - t0) * 1e3, 3))
        state = self._state.replace(step=self._state.step + self._n)
        self._reset()
        return state, MetricHistory(series)

    # -- convenience -------------------------------------------------------
    def run(self, state, batches: Iterable):
        """Drive a whole batch stream: ``start`` on the first batch,
        ``submit`` everything, ``finish``."""
        it = iter(batches)
        try:
            first = next(it)
        except StopIteration:
            return state, MetricHistory({})
        self.start(state, first)
        self.submit(first)
        for batch in it:
            self.submit(batch)
        return self.finish()
