"""The collectives the strategies, the gradient hooks and the mesh-axis
collectives issue, counted.

Every collective of a training step (the gradient reductions, the
parameter gathers, the norm's reduction, the start-up broadcast, a hook's
buckets and ring hops) goes through these functions, so a step's
collective set is observable the way the kernel wrappers' launches are:
``counts[name]`` adds one per call, ``wire_bytes["<name>.<dtype>"]``
the bytes this rank put into it (its input: the tensor reduced, gathered
from or sent), and ``group_counts[name, group]`` the call on the group it
ran on (a mesh axis's: the dry-run grid asks which axis a family's
collectives span). ``calls`` keeps each call itself, in order: its
collective, the dtype and shape of the tensor it moved, its group, and its
bytes in the terms of the reference's compiled HLO (the tensor reduced for
an all-reduce or a reduce-scatter, the whole gathered tensor for an
all-gather, the tensor sent or received for a point-to-point exchange),
which do not depend on the group's size: the IR audit's inventory
(``analysis.ir.inventory``) reads it. It holds at most ``CALL_LOG_LIMIT``
calls (``calls_dropped`` counts the rest), and ``recording()`` collects
the calls of a block apart from it. The four strategy collectives are
always in
``counts``; the others (``all_to_all``, ``send``, ``recv``, ``barrier``)
appear at their first call after ``reset_counts``. The counts are what
``ShardingStrategy.collective_signature`` describes
(``tests/test_torch_port_sharding_ranks.py`` holds them to it).

Each call is synchronous (``async_op=False``) on the caller's stream, so a
CUDA graph capture of the step records it. A call on a one-rank group is
issued all the same: its count and its place in the graph do not depend on
the group's size.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.distributed.batch_ops import (
    P2POp,
    batch_isend_irecv,
)

__all__ = ["counts", "wire_bytes", "group_counts", "calls", "Call",
           "recording", "reset_counts", "all_reduce", "reduce_scatter",
           "all_gather", "broadcast", "all_to_all", "p2p", "barrier"]

_BASE = ("all_reduce", "reduce_scatter", "all_gather", "broadcast")

#: calls per collective since the last ``reset_counts``
counts: Dict[str, int] = dict.fromkeys(_BASE, 0)
#: bytes per ``"<collective>.<dtype>"`` since the last ``reset_counts``
wire_bytes: Dict[str, int] = {}
#: calls per ``(collective, group)`` since the last ``reset_counts`` (the
#: group object a call was given; None is the default group)
group_counts: Dict[Tuple[str, Any], int] = {}


class Call(NamedTuple):
    """One collective call: ``name`` as in ``counts``, the ``dtype`` and
    ``shape`` of the tensor it moved (the reduced or gathered whole, or
    the one sent or received), its ``group`` and ``nbytes`` of that
    tensor."""
    name: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    group: Any
    nbytes: int


#: every call since the last ``reset_counts``, in order, up to
#: ``CALL_LOG_LIMIT`` of them (a long eager run would grow it without end)
calls: List[Call] = []
CALL_LOG_LIMIT = 1 << 16
#: calls made past the limit, not kept in ``calls``
calls_dropped = 0
_recorders: List[List[Call]] = []


def reset_counts() -> None:
    global calls_dropped
    counts.clear()
    counts.update(dict.fromkeys(_BASE, 0))
    wire_bytes.clear()
    group_counts.clear()
    calls.clear()
    calls_dropped = 0


@contextlib.contextmanager
def recording():
    """Yields a list that receives every call made inside the block,
    whatever ``calls`` holds (an audit's record of one step)."""
    rec: List[Call] = []
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def _count(name: str, t: Optional[torch.Tensor], group,
           result: Optional[torch.Tensor] = None) -> None:
    """Count a call of ``name`` whose input is ``t`` (its wire bytes) and
    whose record is of ``result`` (``t`` where None)."""
    global calls_dropped
    counts[name] = counts.get(name, 0) + 1
    group_counts[name, group] = group_counts.get((name, group), 0) + 1
    result = t if result is None else result
    if result is not None:
        call = Call(name, result.dtype, tuple(result.shape), group,
                    result.numel() * result.element_size())
        if len(calls) < CALL_LOG_LIMIT:
            calls.append(call)
        else:
            calls_dropped += 1
        for rec in _recorders:
            rec.append(call)
    if t is None:
        return
    key = f"{name}.{str(t.dtype).removeprefix('torch.')}"
    wire_bytes[key] = wire_bytes.get(key, 0) + t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``-reduced) over ``group``, in place."""
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Rank ``r`` of ``group`` gets block ``r`` (along dim 0) of the sum of
    every rank's ``inp`` in ``out``."""
    _count("reduce_scatter", inp, group)
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` stacked along dim 0 of ``out``, in rank order."""
    _count("all_gather", inp, group, out)
    dist.all_gather_into_tensor(out, inp, group=group)
    return out


def broadcast(t: torch.Tensor, group, group_src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``group_src`` on every rank, in place."""
    _count("broadcast", t, group)
    dist.broadcast(t, dist.get_global_rank(group, group_src), group=group)
    return t


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` (along dim 0) of rank ``i``'s ``inp`` lands in block
    ``i`` of rank ``j``'s ``out``."""
    _count("all_to_all", inp, group)
    dist.all_to_all_single(out, inp, group=group)
    return out


def p2p(group, sends=(), recvs=()) -> None:
    """Post every ``(tensor, dst)`` send and ``(tensor, src)`` receive
    (ranks of ``group``) before waiting on any (``batch_isend_irecv``), then
    wait for all: a ring hop that cannot deadlock on the ranks' order."""
    ops: List = []
    for t, dst in sends:
        _count("send", t, group)
        ops.append(P2POp("isend", t, dst))
    for t, src in recvs:
        _count("recv", None, group, t)
        ops.append(P2POp("irecv", t, src))
    for w in batch_isend_irecv(group, ops):
        w.wait()


def barrier(group) -> None:
    _count("barrier", None, group)
    dist.barrier(group=group)
