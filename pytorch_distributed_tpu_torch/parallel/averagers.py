"""Model averaging (torch ``distributed/algorithms/model_averaging``):
periodic parameter averaging for post-local-SGD training, and an EMA.

Port of ``pytorch_distributed_tpu/parallel/averagers.py``. Ranks step
locally (no gradient sync) for ``period`` steps, then
:class:`PeriodicModelAverager` averages the parameters over the group
with one coalesced all-reduce per dtype (``batch_ops.coalescing_manager``).
The tensors stay on their device: the reference's ``device_get`` to the
host has no counterpart. ``params`` is a dict of tensors, a list of them,
or a module (its parameters, averaged in place).
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch
import torch.nn as nn

from pytorch_distributed_tpu_torch.distributed.batch_ops import (
    coalescing_manager,
)
from pytorch_distributed_tpu_torch.distributed.process_group import ReduceOp

__all__ = ["PeriodicModelAverager", "EMAAverager", "average_parameters"]

Params = Union[Dict[str, torch.Tensor], List[torch.Tensor], nn.Module]


@torch.no_grad()
def average_parameters(params: Params, group) -> Params:
    """The mean over ``group`` (the port's ``ProcessGroup`` or a c10d
    group) of every tensor of ``params``, with one all-reduce per dtype.
    A dict or list gives a new one; a module's parameters are averaged in
    place and the module is returned."""
    if isinstance(params, nn.Module):
        tensors = list(params.parameters())
    elif isinstance(params, dict):
        tensors = list(params.values())
    else:
        tensors = list(params)
    with coalescing_manager(group) as cm:
        slots = [cm.all_reduce(t, ReduceOp.AVG) for t in tensors]
    if isinstance(params, nn.Module):
        for t, slot in zip(tensors, slots):
            t.copy_(slot.result)
        return params
    if isinstance(params, dict):
        return {k: s.result for k, s in zip(params, slots)}
    return [s.result for s in slots]


class PeriodicModelAverager:
    """Average the parameters every ``period`` steps after
    ``warmup_steps`` (torch ``PeriodicModelAverager``). Call
    :meth:`average` every step: it returns ``params`` as they are except on
    an averaging step."""

    def __init__(self, group, *, period: int, warmup_steps: int = 0):
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.group = group
        self.period = period
        self.warmup_steps = warmup_steps
        self.step = 0

    def average(self, params: Params) -> Params:
        self.step += 1
        if self.step <= self.warmup_steps:
            return params
        if (self.step - self.warmup_steps) % self.period:
            return params
        return average_parameters(params, self.group)


class EMAAverager:
    """Exponential moving average of parameters:
    ``shadow = decay * shadow + (1 - decay) * params``."""

    def __init__(self, decay: float = 0.999):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in params.items()}

    @torch.no_grad()
    def update(self, shadow: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        d = self.decay
        return {k: d * shadow[k] + (1.0 - d) * params[k] for k in shadow}
