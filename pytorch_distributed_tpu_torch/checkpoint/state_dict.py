"""FQN state dicts of the port's training state, and the Stateful protocol.

Port of ``pytorch_distributed_tpu/checkpoint/state_dict.py``. There the
whole state is one pytree, flattened to ``'a/b/c'`` keys. Here the state
lives in three places, and :func:`get_state_dict` flattens all three to
one ``{fqn: tensor}`` dict:

* ``model/<name>``: ``model.state_dict()``, BatchNorm's buffers included;
* ``optim/<parameter name>/<key>``: the optimizer's state by parameter
  name (``exp_avg``, ``exp_avg_sq``, ``step``; ``momentum_buffer``);
* ``train/step``, ``train/scaler/scale``, ``train/scaler/growth_tracker``:
  the :class:`TrainState`'s step and loss-scaler state.

The keys are the same under every strategy, so a checkpoint moves between
them. A tensor held sharded (FSDP's parameter blocks and their optimizer
state, ZeRO1's state blocks; ``parallel.fsdp.local_block`` cuts them as
``torch.chunk`` does) enters as a ``DTensor`` view of the live block over
the strategy's mesh, ``Shard(dim)`` on its axis and ``Replicate()`` on the
others: ``torch.distributed.checkpoint`` then writes each rank's block and
reads any layout back into any other (FSDP to one rank, four ranks to two).
Every value is a view of the live tensor, so loading into the dict
restores in place.

:func:`set_state_dict` is the inverse: it copies a state dict's values
into the live tensors (a value that is already the live tensor is left as
it is; a whole tensor is cut to the live block) and returns the
``TrainState`` with the saved step. Tensors never move: the pipelined
runner keeps its captured step across a restore. A missing key raises
``KeyError``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Protocol, Tuple, runtime_checkable

import torch

from pytorch_distributed_tpu_torch.parallel.fsdp import local_block
from pytorch_distributed_tpu_torch.parallel.state import TrainState

__all__ = ["Stateful", "get_state_dict", "set_state_dict",
           "model_state_dict"]


@runtime_checkable
class Stateful(Protocol):
    """Objects that save and restore themselves inside a checkpoint (torch
    ``checkpoint/stateful.py``); ``torch.distributed.checkpoint`` calls
    them when they are values of the state dict it saves or loads."""

    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None: ...


# (live tensor, mesh axis it is sharded over or None, dim)
_Entry = Tuple[torch.Tensor, Optional[str], Optional[int]]


def _view(entry: _Entry, strategy):
    """The live tensor, or a DTensor view of its block."""
    t, axis, dim = entry
    if axis is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = strategy.mesh
    shape = list(t.shape)
    shape[dim] *= mesh.size(axis)
    placements = [Shard(dim) if a == axis else Replicate()
                  for a in mesh.axis_names]
    return DTensor.from_local(
        t, mesh._mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _model_entries(model: torch.nn.Module, strategy) -> Iterator:
    if any(hasattr(p, "tp") for p in model.parameters()):
        raise NotImplementedError(
            "not ported yet: checkpoints of a tensor-parallel model's state "
            "(ROADMAP A.14); serving loads its blocks with "
            "serving.load_gpt2_params")
    sharded = {n: p.fsdp for n, p in model.named_parameters()
               if hasattr(p, "fsdp")}
    axis = getattr(strategy, "param_axis", None)
    for name, t in model.state_dict().items():
        spec = sharded.get(name)
        yield (f"model/{name}",
               (t, axis, spec.dim) if spec is not None else (t, None, None))


def _optim_entries(trainer) -> Iterator:
    opt, layout, strategy = trainer.optimizer, trainer.layout, trainer.strategy
    if layout is not None:
        leaves = [(leaf.name, leaf.tensor,
                   (strategy.param_axis, leaf.param_shard.dim)
                   if leaf.param_shard is not None else
                   (strategy.update_axis, leaf.update_shard.dim)
                   if leaf.update_shard is not None else (None, None))
                  for leaf in layout.leaves]
    else:
        leaves = [(n, p, (None, None))
                  for n, p in trainer.model.named_parameters()]
    for name, tensor, (axis, dim) in leaves:
        for key, v in opt.state.get(tensor, {}).items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"optimizer state {name}/{key} is not a "
                                "tensor")
            shard = axis is not None and v.shape == tensor.shape
            yield (f"optim/{name}/{key}",
                   (v, axis, dim) if shard else (v, None, None))


def _train_entries(state: TrainState) -> Iterator:
    if state.comm_state is not None:
        raise NotImplementedError(
            "checkpointing a communication hook's state: the hooks are "
            "ROADMAP A.14")
    yield "train/step", (torch.tensor(state.step, dtype=torch.int64),
                         None, None)
    if state.scaler is not None:
        yield "train/scaler/scale", (state.scaler.scale, None, None)
        yield ("train/scaler/growth_tracker",
               (state.scaler.growth_tracker, None, None))


def _entries(trainer, state: TrainState) -> Dict[str, _Entry]:
    out = dict(_model_entries(trainer.model, trainer.strategy))
    out.update(_optim_entries(trainer))
    out.update(_train_entries(state))
    return out


def get_state_dict(trainer, state: TrainState) -> Dict[str, Any]:
    """The flat FQN state dict of ``trainer``'s model and optimizer and of
    ``state`` (see the module's docstring), every value a view of the live
    tensor (``train/step`` a fresh int64 scalar)."""
    return {k: _view(e, trainer.strategy)
            for k, e in _entries(trainer, state).items()}


def model_state_dict(model: torch.nn.Module, strategy=None) -> Dict[str, Any]:
    """The ``model/...`` part of :func:`get_state_dict` alone (the weights
    a server loads)."""
    return {k: _view(e, strategy) for k, e in _model_entries(model, strategy)}


def _local(value) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return value.to_local() if isinstance(value, DTensor) else value


@torch.no_grad()
def set_state_dict(trainer, state: TrainState,
                   state_dict: Dict[str, Any]) -> TrainState:
    """Copy ``state_dict`` into ``trainer``'s live tensors and ``state``'s
    scaler (in place) and return ``state`` at the saved step. Extra keys
    are ignored; a missing one raises ``KeyError``."""
    for key, (live, axis, dim) in _entries(trainer, state).items():
        if key not in state_dict:
            raise KeyError(f"state_dict missing key {key!r}")
        if key == "train/step":
            continue
        value = _local(state_dict[key])
        if (value.data_ptr() == live.data_ptr()
                and value.shape == live.shape):
            continue                       # loaded in place already
        if axis is not None and value.shape != live.shape:
            spec_size = trainer.strategy.mesh.size(axis)
            spec_rank = trainer.strategy.mesh.get_local_rank(axis)
            value = local_block(value, dim, spec_rank, spec_size)
        live.copy_(value)
    return state.replace(step=int(_local(state_dict["train/step"])))
