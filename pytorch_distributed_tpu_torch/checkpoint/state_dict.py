"""FQN state dicts of the port's training state, and the Stateful protocol.

Port of ``pytorch_distributed_tpu/checkpoint/state_dict.py``. There the
whole state is one pytree, flattened to ``'a/b/c'`` keys. Here the state
lives in three places, and :func:`get_state_dict` flattens all three to
one ``{fqn: tensor}`` dict:

* ``model/<name>``: ``model.state_dict()``, BatchNorm's buffers included;
* ``optim/<parameter name>/<key>``: the optimizer's state by parameter
  name (``exp_avg``, ``exp_avg_sq``, ``step``; ``momentum_buffer``);
* ``train/step``, ``train/scaler/scale``, ``train/scaler/growth_tracker``:
  the :class:`TrainState`'s step and loss-scaler state;
* ``train/comm/<leaf>/<key>``: a stateful comm hook's ``comm_state``
  (PowerSGD's ``q`` and ``e``; its warm-up branch reads ``train/step``).

The keys and the saved shapes are those of the unsharded model under
every strategy, so a checkpoint moves between them. A tensor held sharded
(FSDP's parameter blocks and their optimizer state, ZeRO1's state blocks,
a tensor-parallel parameter's tp block and its moments, both under TP x
FSDP, an expert stack's ep block and its moments under
``ExpertDataParallel``; ``parallel.fsdp.local_block`` cuts as
``torch.chunk`` does) enters
as a ``DTensor`` view of the live block over the strategy's mesh,
``Shard(dim)`` on each axis it is cut over and ``Replicate()`` on the
others: ``torch.distributed.checkpoint`` then writes each rank's block and
reads any layout back into any other (FSDP to one rank, four ranks to two,
tp 4 to ``serving.load_gpt2_params`` at tp 1 or 2). Every value is a view
of the live tensor, so loading into the dict restores in place, with two
exceptions. GPT-2's fused ``c_attn`` gives a tp rank its rows of each of
q, k and v, which is not one ``Shard`` of ``[3C, C]``: its weight, bias and
moments are gathered whole over tp (a copy; collective; at GPT-2 125M
12 x 7.1 MB of weight and twice that of AdamW moments a save) and cut
back after a load. A comm hook's per-rank buffers (PowerSGD's ``e``) are
each rank's block of one tensor ``Shard(0)`` over dp, so every rank's
buffer is kept; Q, the same on every rank, is saved once.

:func:`set_state_dict` is the inverse: it copies a state dict's values
into the live tensors (a value that is already the live tensor is left as
it is; a whole tensor is cut to the live block; a gathered copy is cut
back into its tp block) and returns the ``TrainState`` with the saved
step. Tensors never move: the pipelined
runner keeps its captured step across a restore. A missing key raises
``KeyError``.
"""

from __future__ import annotations

import functools
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    NamedTuple,
    Optional,
    Protocol,
    runtime_checkable,
)

import torch

from pytorch_distributed_tpu_torch.parallel.fsdp import local_block
from pytorch_distributed_tpu_torch.parallel.state import TrainState
from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
    tp_block,
    tp_full_tensor,
)

__all__ = ["Stateful", "get_state_dict", "set_state_dict",
           "model_state_dict", "load_model_state"]


@runtime_checkable
class Stateful(Protocol):
    """Objects that save and restore themselves inside a checkpoint (torch
    ``checkpoint/stateful.py``); ``torch.distributed.checkpoint`` calls
    them when they are values of the state dict it saves or loads."""

    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None: ...


class _Entry(NamedTuple):
    """One state-dict value: ``tensor`` (the live tensor, or a copy whole
    on tp of a fused projection's block), the ``{mesh axis: dim}`` it is a
    block along (empty: whole), and ``restore``, which puts a loaded copy
    back into the live tensor (None: ``tensor`` is the live one)."""
    tensor: torch.Tensor
    dims: Dict[str, int]
    restore: Optional[Callable[[], None]] = None


def _view(entry: _Entry, strategy):
    """The tensor, or a DTensor view of its block: ``Shard(dim)`` on each
    axis of ``entry.dims``, ``Replicate()`` on the mesh's other axes."""
    t, dims = entry.tensor, entry.dims
    if not dims:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = strategy.mesh
    shape = list(t.shape)
    for axis, dim in dims.items():
        shape[dim] *= mesh.size(axis)
    placements = [Shard(dims[a]) if a in dims else Replicate()
                  for a in mesh.axis_names]
    return DTensor.from_local(
        t, mesh._mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


@torch.no_grad()
def _cut_into(live: torch.Tensor, whole: torch.Tensor, spec) -> None:
    live.copy_(tp_block(whole, spec))


def _placed(t: torch.Tensor, p: torch.Tensor, strategy) -> _Entry:
    """The entry of ``t``, a tensor shaped like the block that parameter
    ``p`` holds (the parameter itself, or its optimizer moments): a block
    along the dim of each axis ``p`` shards over. A fused projection's tp
    block (GPT-2's ``c_attn``: this rank's rows of each of q, k and v) is
    not one block of the whole tensor: it is gathered whole over tp here
    (a collective) and cut back after a load, so the saved tensor has the
    unsharded model's shape."""
    dims = {}
    fsdp = getattr(p, "fsdp", None)
    if fsdp is not None:
        dims[strategy.param_axis] = fsdp.dim
    ep = getattr(p, "ep", None)
    if ep is not None:
        dims[strategy.ep_axis] = ep.dim
    tp = getattr(p, "tp", None)
    if tp is None:
        return _Entry(t, dims)
    if tp.chunks == 1:
        dims[strategy.tp_axis] = tp.dim
        return _Entry(t, dims)
    whole = tp_full_tensor(t, tp)
    return _Entry(whole, dims, functools.partial(_cut_into, t, whole, tp))


def _check_strategy(model: torch.nn.Module, strategy) -> None:
    if strategy is None and any(hasattr(p, "tp") or hasattr(p, "fsdp")
                                or hasattr(p, "ep")
                                for p in model.parameters()):
        raise ValueError("a sharded model's state dict needs its strategy "
                         "(the mesh its blocks are placed over)")


def _model_entries(model: torch.nn.Module, strategy) -> Iterator:
    _check_strategy(model, strategy)
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        p = params.get(name)
        yield (f"model/{name}",
               _placed(t, p, strategy) if p is not None else _Entry(t, {}))


def _optim_entries(trainer) -> Iterator:
    opt, layout, strategy = trainer.optimizer, trainer.layout, trainer.strategy
    if layout is not None:
        leaves = [(leaf.name, leaf.param, leaf.tensor,
                   {strategy.update_axis: leaf.update_shard.dim}
                   if leaf.update_shard is not None else None)
                  for leaf in layout.leaves]
    else:
        leaves = [(n, p, p, None)
                  for n, p in trainer.model.named_parameters()]
    for name, param, tensor, update_dims in leaves:
        for key, v in opt.state.get(tensor, {}).items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"optimizer state {name}/{key} is not a "
                                "tensor")
            if v.shape != tensor.shape:     # Adam's step count
                entry = _Entry(v, {})
            elif update_dims is not None:   # ZeRO1's update block
                entry = _Entry(v, update_dims)
            else:
                entry = _placed(v, param, strategy)
            yield f"optim/{name}/{key}", entry


def _train_entries(trainer, state: TrainState) -> Iterator:
    yield "train/step", _Entry(torch.tensor(state.step, dtype=torch.int64),
                               {})
    if state.scaler is not None:
        yield "train/scaler/scale", _Entry(state.scaler.scale, {})
        yield ("train/scaler/growth_tracker",
               _Entry(state.scaler.growth_tracker, {}))
    if state.comm_state is None:
        return
    # a stateful comm hook's state (PowerSGD: each leaf's Q, agreed by
    # every rank, and each rank's own error buffer): the per-rank tensors
    # are the blocks of one tensor sharded over the hook's dp axis, so
    # every rank's buffer is saved and each gets its own back
    per_rank = getattr(trainer.comm_hook, "per_rank_keys", ())
    dp_axis = trainer.strategy.dp_axis
    for leaf, entry in state.comm_state.items():
        for key, v in entry.items():
            yield (f"train/comm/{leaf}/{key}",
                   _Entry(v, {dp_axis: 0} if key in per_rank else {}))


def _entries(trainer, state: TrainState) -> Dict[str, _Entry]:
    out = dict(_model_entries(trainer.model, trainer.strategy))
    out.update(_optim_entries(trainer))
    out.update(_train_entries(trainer, state))
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


@torch.no_grad()
def load_model_state(model: torch.nn.Module, strategy, load) -> None:
    """``load(state_dict)`` into :func:`model_state_dict`'s views, then the
    gathered copies cut back into the live blocks."""
    entries = dict(_model_entries(model, strategy))
    load({k: _view(e, strategy) for k, e in entries.items()})
    for e in entries.values():
        if e.restore is not None:
            e.restore()


def _local(value) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return value.to_local() if isinstance(value, DTensor) else value


@torch.no_grad()
def set_state_dict(trainer, state: TrainState,
                   state_dict: Dict[str, Any]) -> TrainState:
    """Copy ``state_dict`` into ``trainer``'s live tensors and ``state``'s
    scaler (in place) and return ``state`` at the saved step. Extra keys
    are ignored; a missing one raises ``KeyError``."""
    mesh = trainer.strategy.mesh if hasattr(trainer.strategy, "mesh") else None
    for key, entry in _entries(trainer, state).items():
        if key not in state_dict:
            raise KeyError(f"state_dict missing key {key!r}")
        if key == "train/step":
            continue
        live = entry.tensor
        value = _local(state_dict[key])
        if not (value.data_ptr() == live.data_ptr()
                and value.shape == live.shape):    # else: loaded in place
            if value.shape != live.shape:
                for axis, dim in entry.dims.items():
                    value = local_block(value, dim, mesh.get_local_rank(axis),
                                        mesh.size(axis))
            live.copy_(value)
        if entry.restore is not None:
            entry.restore()
    return state.replace(step=int(_local(state_dict["train/step"])))
