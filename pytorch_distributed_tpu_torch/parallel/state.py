"""Train state: what the step carries besides the model and optimizer.

Port of ``pytorch_distributed_tpu/parallel/state.py``. In JAX the whole
state (params, optimizer state, scaler) is one pytree threaded through the
jitted step. In torch the parameters live in the model and the optimizer
state in the optimizer, both updated in place by ``Trainer.step``, so the
state object keeps the rest: the step count, the loss-scaler state and a
stateful communication hook's state (PowerSGD's Q and error buffers,
which its ``apply`` updates in place; ``None`` without such a hook).

:func:`make_state_specs` is the counterpart of the reference's: where a
parameter and its optimizer state are held sharded, and along which dim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from pytorch_distributed_tpu_torch.amp.grad_scaler import GradScalerState

__all__ = ["TrainState", "make_state_specs"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int = 0
    scaler: Optional[GradScalerState] = None
    comm_state: Optional[Any] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_state_specs(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     strategy) -> Dict[str, Dict]:
    """The shard dim (None: whole) of every parameter, buffer and
    optimizer-state tensor under ``strategy``, by name, over the whole
    tensors' torch shapes:

    * ``params``: ``{name: strategy.param_pspec(name, shape)}``;
    * ``model_state``: ``{buffer name: strategy.model_state_pspec(...)}``;
    * ``opt_state``: ``{name: {key: dim}}``: a state tensor shaped like its
      parameter follows ``strategy.opt_pspec``; a scalar (Adam's ``step``)
      stays whole.

    Read it before ``Trainer.init`` (the optimizer's state, which ``init``
    creates, is taken from a parameter's shape where it does not exist
    yet: Adam's moments and SGD's momentum are shaped like it)."""
    names = {id(p): n for n, p in model.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    opt_state: Dict[str, Dict] = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names.get(id(p))
            if name is None:
                continue
            state = optimizer.state.get(p) or _state_like(optimizer, group, p)
            opt_state[name] = {
                k: (strategy.opt_pspec(name, shapes[name])
                    if tuple(getattr(v, "shape", ())) == shapes[name]
                    and shapes[name] else None)
                for k, v in state.items()}
    return {
        "params": {n: strategy.param_pspec(n, s) for n, s in shapes.items()},
        "model_state": {n: strategy.model_state_pspec(n, tuple(b.shape))
                        for n, b in model.named_buffers()},
        "opt_state": opt_state,
    }


def _state_like(optimizer, group, p) -> Dict[str, Any]:
    """The state ``Trainer.init`` will create for ``p`` (shapes only)."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        keys = ["exp_avg", "exp_avg_sq"] + (
            ["max_exp_avg_sq"] if group.get("amsgrad") else [])
        return {"step": torch.zeros(()), **{k: p for k in keys}}
    if isinstance(optimizer, torch.optim.SGD) and group["momentum"]:
        return {"momentum_buffer": p}
    return {}
