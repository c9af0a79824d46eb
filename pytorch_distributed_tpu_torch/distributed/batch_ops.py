"""Batched point-to-point ops and the coalescing manager.

Port of ``pytorch_distributed_tpu/distributed/batch_ops.py`` (torch
``distributed_c10d.py`` ``P2POp``, ``batch_isend_irecv``,
``_coalescing_manager``). A ``group`` here is the port's
:class:`~.process_group.ProcessGroup` or a c10d group (a mesh axis's, which
the gradient hooks run on).

* :func:`batch_isend_irecv` posts every op before waiting on any, so a
  ring exchange cannot deadlock on the ranks' op order. On a c10d group it
  is c10d's ``batch_isend_irecv`` (NCCL groups the ops in one
  ``ncclGroupStart/End``); on a port group whose c10d object the registry
  does not know (a shrunk group) the sends are posted first, then the
  receives, as the reference does.
* :class:`CoalescingManager` records ``all_reduce`` calls inside its
  context and, on exit, runs one all-reduce per (op, dtype): the tensors of
  one dtype flattened into one buffer, the result split back into each
  call's slot. The tensors stay on their device.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.distributed.process_group import (
    C10dBackend,
    ProcessGroup,
    ReduceOp,
    Work,
)

__all__ = ["P2POp", "batch_isend_irecv", "coalescing_manager",
           "CoalescingManager", "as_process_group"]


def as_process_group(group) -> ProcessGroup:
    """The port's :class:`ProcessGroup` for ``group``: itself, or a fresh
    one over a c10d group (the default group for None)."""
    if isinstance(group, ProcessGroup):
        return group
    group = group if group is not None else dist.group.WORLD
    return ProcessGroup(C10dBackend(group), group_name=getattr(
        group, "group_name", "c10d"))


@dataclasses.dataclass
class P2POp:
    """One op of a batched P2P round (torch ``P2POp``): ``op`` is the string
    ``"isend"`` or ``"irecv"``, ``peer`` the remote rank within the group.
    Both take a tensor: c10d receives into a buffer."""

    op: str
    tensor: Optional[torch.Tensor]
    peer: int
    tag: int = 0

    def __post_init__(self):
        if self.op not in ("isend", "irecv"):
            raise ValueError(f"P2POp.op must be isend|irecv, got {self.op}")
        if self.tensor is None:
            raise ValueError(f"{self.op} needs a tensor")


def _registered(group) -> bool:
    """c10d's registry knows this group (so ``torch.distributed``'s module
    functions take it)."""
    try:
        dist.get_group_rank(group, dist.get_rank())
        return True
    except (RuntimeError, ValueError, TypeError, KeyError):
        return False


class _Once:
    """c10d works waited on once, whichever handle waits first (a gloo
    send's work waits for one more send at each ``wait``)."""

    def __init__(self, works):
        self.works = works
        self.done = False

    def wait(self, timeout=None):
        if not self.done:
            for w in self.works:
                w.wait() if timeout is None else w.wait(timeout)
            self.done = True
        return True

    def is_completed(self) -> bool:
        return self.done or all(w.is_completed() for w in self.works)


def batch_isend_irecv(group, ops: Sequence[P2POp]) -> List[Work]:
    """Post every op before waiting on any. Returns one :class:`Work` per
    op, parallel to ``ops``; an irecv's ``result()`` is its tensor."""
    if not ops:
        return []
    if isinstance(group, ProcessGroup):
        c10d = (group.backend.group
                if isinstance(group.backend, C10dBackend) else None)
    else:
        c10d = group if group is not None else dist.group.WORLD
    if c10d is not None and _registered(c10d):
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend if o.op == "isend" else dist.irecv,
                       o.tensor, dist.get_global_rank(c10d, o.peer), c10d,
                       o.tag)
            for o in ops])
        if len(works) == len(ops):
            return [Work([w], (lambda t=o.tensor: t), o.op)
                    for w, o in zip(works, ops)]
        once = _Once(works)     # NCCL's coalesced ops: one work for all
        return [Work([once], (lambda t=o.tensor: t), o.op) for o in ops]
    group = as_process_group(group)
    out: List[Optional[Work]] = [None] * len(ops)
    for i, o in enumerate(ops):    # sends first, as the reference posts
        if o.op == "isend":
            out[i] = group.isend(o.tensor, o.peer, o.tag)
    for i, o in enumerate(ops):
        if o.op == "irecv":
            out[i] = group.irecv(o.tensor, o.peer, o.tag)
    return out


class CoalescingManager:
    """Batch same-op all-reduces into one wire transfer per (op, dtype)::

        with coalescing_manager(pg) as cm:
            h1 = cm.all_reduce(grad_a)
            h2 = cm.all_reduce(grad_b)
        # one all-reduce ran; h1.result / h2.result hold the sums
    """

    @dataclasses.dataclass
    class _Slot:
        shape: tuple
        dtype: torch.dtype
        result: Optional[torch.Tensor] = None

    def __init__(self, group):
        self.pg = as_process_group(group)
        self._entries = []
        self._done = False

    def all_reduce(self, t: torch.Tensor, op: Optional[ReduceOp] = None):
        slot = self._Slot(tuple(t.shape), t.dtype)
        self._entries.append((op or ReduceOp.SUM, t.reshape(-1), slot))
        return slot

    def wait(self) -> None:
        if self._done:
            return
        self._done = True
        groups = defaultdict(list)
        for op, flat, slot in self._entries:
            groups[(op, flat.dtype, flat.device)].append((flat, slot))
        for (op, _, _), members in groups.items():
            fused = torch.cat([f for f, _ in members])
            out = self.pg.all_reduce(fused, op).result()
            for (flat, slot), part in zip(
                    members, out.split([f.numel() for f, _ in members])):
                slot.result = part.view(slot.shape)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.wait()
        return False


def coalescing_manager(group) -> CoalescingManager:
    return CoalescingManager(group)
