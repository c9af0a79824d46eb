"""The collectives the strategies issue, counted.

Every collective of a training step (the gradient reductions, the
parameter gathers, the norm's reduction, the start-up broadcast) goes
through these four functions, so a step's collective set is observable
the way the kernel wrappers' launches are: ``counts[name]`` adds one per
call. The counts are what ``ShardingStrategy.collective_signature``
describes (``tests/test_torch_port_sharding_ranks.py`` holds them to it).

Each call is synchronous (``async_op=False``) on the caller's stream, so a
CUDA graph capture of the step records it. A call on a one-rank group is
issued all the same: its count and its place in the graph do not depend on
the group's size.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["counts", "reset_counts", "all_reduce", "reduce_scatter",
           "all_gather", "broadcast"]

#: calls per collective since the last ``reset_counts``
counts: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                          "all_gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``-reduced) over ``group``, in place."""
    counts["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Rank ``r`` of ``group`` gets block ``r`` (along dim 0) of the sum of
    every rank's ``inp`` in ``out``."""
    counts["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` stacked along dim 0 of ``out``, in rank order."""
    counts["all_gather"] += 1
    dist.all_gather_into_tensor(out, inp, group=group)
    return out


def broadcast(t: torch.Tensor, group, group_src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``group_src`` on every rank, in place."""
    counts["broadcast"] += 1
    dist.broadcast(t, dist.get_global_rank(group, group_src), group=group)
    return t
