"""The port's pipeline schedules against the JAX package's, and the stage
links' order on an NCCL group, by simulation (no ranks).

* Every schedule class over ``tests/test_pipeline.py``'s grids (the
  dependency grid, the interleaved, ZB-V, LoopedBFS and DualPipeV tests'
  arguments, and their deadlock sweeps): each rank's action stream and
  ``peak_inflight`` equal the JAX module's, and the constructors refuse
  what the reference's refuse, with its messages.
* NCCL matches a pair's messages in the order they were issued. The
  executor's links on an NCCL group receive a pair's messages in the
  sender's order and keep the early ones (``parallel.stage_links``). The
  simulation runs every rank's stream under blocking receives with those
  semantics: every stream drains, each pair's receives are issued in the
  order of its sends, and nothing is left kept. Where a schedule's own
  order differs between the two sides of a pair (ZB-V, DualPipeV), the
  simulation shows the early messages the links keep.
"""

import itertools

import pytest

from pytorch_distributed_tpu_torch.parallel import pipeline as port

#: the reference's grids: (class name, constructor args)
GRID = (
    [(c, (s, n)) for c in ("ScheduleGPipe", "Schedule1F1B",
                           "ScheduleZeroBubble")
     for s, n in ((2, 4), (4, 4), (4, 8))]
    + [("ScheduleInterleaved1F1B", a) for a in
       ((2, 4, 2), (2, 4, 3), (4, 8, 2))]
    + [("ScheduleInterleavedZeroBubble", a) for a in
       ((2, 4, 2), (2, 4, 3), (4, 8, 2))]
    + [("ScheduleZBVZeroBubble", (p, n)) for p in (2, 3, 4, 5)
       for n in (1, 2, 3, 5, 8, 11)]
    + [("ScheduleLoopedBFS", (p, n, vc)) for p in (2, 3, 4)
       for vc in (1, 2, 3) for n in (1, 2, 5, 8)]
    + [("ScheduleDualPipeV", (p, n)) for p in (2, 3, 4, 5)
       for n in (2 * p, 2 * p + 1, 2 * p + 3, 3 * p, 4 * p)]
    + [("ScheduleDualPipeV", (4, 11))]
)


def _streams(mod, name, args):
    sched = getattr(mod, name)(*args)
    n_stages = args[0]
    return ([[(a.kind, a.microbatch, a.chunk) for a in sched.actions(s)]
             for s in range(n_stages)],
            [sched.peak_inflight(s) for s in range(n_stages)])


@pytest.mark.parametrize("name", sorted({g[0] for g in GRID}))
def test_streams_and_peaks_equal_the_jax_module(name):
    from pytorch_distributed_tpu.parallel import pipeline as ref

    cases = [args for n, args in GRID if n == name]
    assert cases
    for args in cases:
        assert _streams(port, name, args) == _streams(ref, name, args), args


def test_refusals_match_the_reference():
    from pytorch_distributed_tpu.parallel import pipeline as ref

    for name, args in (("ScheduleInterleaved1F1B", (2, 3, 2)),
                       ("ScheduleDualPipeV", (4, 7))):
        with pytest.raises(ValueError) as want:
            getattr(ref, name)(*args)
        with pytest.raises(ValueError) as got:
            getattr(port, name)(*args)
        assert str(got.value) == str(want.value)


def _placement(schedule, world, n_chunks):
    if schedule in ("zbv", "dualpipev"):
        return (lambda r, c: r if c == 0 else 2 * world - 1 - r,
                lambda v: v if v < world else 2 * world - 1 - v)
    return lambda r, c: c * world + r, lambda v: v % world


def _schedule(schedule, world, n_micro, n_chunks):
    if schedule in ("interleaved", "interleaved_zb", "looped_bfs"):
        cls = {"interleaved": port.ScheduleInterleaved1F1B,
               "interleaved_zb": port.ScheduleInterleavedZeroBubble,
               "looped_bfs": port.ScheduleLoopedBFS}[schedule]
        return cls(world, n_micro, n_chunks)
    cls = {"gpipe": port.ScheduleGPipe, "1f1b": port.Schedule1F1B,
           "zb": port.ScheduleZeroBubble, "zbv": port.ScheduleZBVZeroBubble,
           "dualpipev": port.ScheduleDualPipeV}[schedule]
    return cls(world, n_micro)


def simulate_ordered_links(schedule, world, n_micro, n_chunks=1):
    """Run every rank's stream with the executor's message rules (an F
    receives from the previous virtual stage's rank, a B from the next's,
    a same-rank link hands off locally) over NCCL-like links: a send is
    appended to its pair's queue; a receive takes the pair's queue front
    (blocking while it is empty) until the wanted message came, keeping
    the ones before it. Returns (drained, sends by pair, receives issued by
    pair, the most messages ever kept early)."""
    sched = _schedule(schedule, world, n_micro, n_chunks)
    v_of, rank_of = _placement(schedule, world, n_chunks)
    n_virtual = world * n_chunks
    streams = [list(sched.actions(r)) for r in range(world)]
    queues, sent, issued = {}, {}, {}
    early = {r: set() for r in range(world)}
    done, ptr, peak = set(), [0] * world, 0

    def take(r, src, msg):
        """True when ``msg`` from ``src`` is (or becomes) available."""
        if msg in early[r]:
            early[r].discard(msg)
            return True
        q = queues.setdefault((src, r), [])
        while q:
            got = q.pop(0)
            issued.setdefault((src, r), []).append(got)
            if got == msg:
                return True
            early[r].add(got)
        return False

    def send(r, dst, msg):
        queues.setdefault((r, dst), []).append(msg)
        sent.setdefault((r, dst), []).append(msg)

    progressed = True
    while progressed:
        progressed = False
        for r in range(world):
            while ptr[r] < len(streams[r]):
                a = streams[r][ptr[r]]
                v = v_of(r, a.chunk)
                if a.kind == "F":
                    need = (v != 0 and rank_of(v - 1) != r
                            and ("F", v, a.microbatch))
                    if need and not take(r, rank_of(v - 1), need):
                        break
                    if v == 0 or rank_of(v - 1) == r:
                        if v and ("F", v - 1, a.microbatch) not in done:
                            break
                    if v != n_virtual - 1 and rank_of(v + 1) != r:
                        send(r, rank_of(v + 1), ("F", v + 1, a.microbatch))
                elif a.kind == "B":
                    if ("F", v, a.microbatch) not in done:
                        break
                    up = v != n_virtual - 1
                    need = up and rank_of(v + 1) != r and (
                        "B", v + 1, a.microbatch)
                    if need and not take(r, rank_of(v + 1), need):
                        break
                    if up and rank_of(v + 1) == r and (
                            "B", v + 1, a.microbatch) not in done:
                        break
                    if v != 0 and rank_of(v - 1) != r:
                        send(r, rank_of(v - 1), ("B", v, a.microbatch))
                elif ("B", v, a.microbatch) not in done:
                    break
                done.add((a.kind, v, a.microbatch))
                ptr[r] += 1
                progressed = True
                peak = max(peak, max(len(e) for e in early.values()))
    drained = all(p == len(s) for p, s in zip(ptr, streams))
    return drained and not any(early.values()), sent, issued, peak


SCHEDULE_CASES = (
    [(s, w, n, 1) for s in ("gpipe", "1f1b", "zb")
     for w, n in ((2, 4), (4, 4), (4, 8))]
    + [(s, w, n, c) for s in ("interleaved", "interleaved_zb")
       for w, c, n in ((2, 2, 4), (2, 3, 4), (4, 2, 8))]
    + [("looped_bfs", p, n, vc) for p in (2, 3, 4) for vc in (1, 2, 3)
       for n in (1, 2, 5, 8)]
    + [("zbv", p, n, 2) for p in (2, 3, 4, 5) for n in (1, 2, 3, 5, 8, 11)]
    + [("dualpipev", p, n, 2) for p in (2, 3, 4, 5)
       for n in (2 * p, 2 * p + 1, 2 * p + 3, 3 * p, 4 * p)]
)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb", "interleaved",
                                      "interleaved_zb", "looped_bfs", "zbv",
                                      "dualpipev"])
def test_nccl_pair_order(schedule):
    """Each pair's receives are issued in the order of its sends, every
    stream drains under blocking receives, and nothing stays kept. The
    Megatron-placement schedules need no keeping at all; ZB-V and
    DualPipeV do (their two sides of a pair order some messages
    differently), which is why the links keep early messages."""
    peaks = []
    for s, world, n, chunks in SCHEDULE_CASES:
        if s != schedule:
            continue
        ok, sent, issued, peak = simulate_ordered_links(s, world, n, chunks)
        assert ok, (s, world, n, chunks)
        assert issued == sent, (s, world, n, chunks)
        peaks.append(peak)
    assert peaks
    if schedule in ("zbv", "dualpipev"):
        assert max(peaks) > 0
    else:
        assert max(peaks) == 0


def test_simulation_catches_a_deadlock():
    """The simulator is not vacuous: a stream whose first stage runs its
    backwards before any forward never drains."""

    class Backwards:
        def __init__(self, *a):
            pass

        def actions(self, r):
            bwd = [port._Action("B", m) for m in range(2)]
            fwd = [port._Action("F", m) for m in range(2)]
            return bwd + fwd if r == 0 else fwd + bwd

    real = port.ScheduleGPipe
    port.ScheduleGPipe = Backwards
    try:
        ok, _, _, _ = simulate_ordered_links("gpipe", 2, 2)
    finally:
        port.ScheduleGPipe = real
    assert not ok


def test_peak_residuals_and_action_repr():
    acts = [port._Action(k, m) for k, m in
            itertools.product("FW", range(3))]
    assert port._peak_residuals(acts) == 3
    assert repr(port._Action("B", 2, 1)) == "B2.1"
    assert repr(port._Action("F", 0)) == "F0"


def test_stack_stage_params_matches_the_jax_module():
    import numpy as np
    import torch

    from pytorch_distributed_tpu.parallel.pipeline import (
        stack_stage_params as ref_stack,
    )

    rng = np.random.default_rng(0)
    layers = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
               "b": rng.standard_normal(2).astype(np.float32)}
              for _ in range(4)]
    want = ref_stack(layers)
    got = port.stack_stage_params(
        [{k: torch.tensor(v) for k, v in layer.items()} for layer in layers])
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
