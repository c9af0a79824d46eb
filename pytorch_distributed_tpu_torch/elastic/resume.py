"""Elastic resume onto the current world.

Port of ``pytorch_distributed_tpu/elastic/resume.py``. When the agent
restarts its workers (after a failure or a change of membership), each new
process builds its trainer on the world that exists now, which need not be
the one the newest checkpoint was written on. :func:`resume_from_checkpoint`
restores that checkpoint into the new trainer's live tensors in place,
resharding through ``torch.distributed.checkpoint`` (each rank reads its
own slice of whatever layout was saved).

:func:`reshard_state` is the no-disk variant: it moves a live state (the
survivors of a resize) onto the new layout through the ``redistribute``
planner, every leaf in one planned transfer; :func:`state_shardings`
gives that layout, where a strategy built on the new mesh holds each
value (an ``ExpertDataParallel`` trainer's expert stacks and their
moments on the new ep size, FSDP's blocks on the new fsdp size, a
tensor-parallel model's blocks on the new tp size, a pipeline's layers on
the ranks of their new stage). A pipelined state enters through
:func:`placed_state`: every rank then names every layer, each held whole
by its stage's ranks, so a layer that keeps its ranks moves no byte and
one whose stage changes goes point to point from a holder.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from pytorch_distributed_tpu_torch.parallel.state import TrainState

__all__ = ["resume_from_checkpoint", "reshard_state", "state_shardings",
           "placed_state"]


def resume_from_checkpoint(directory: str, trainer, state: TrainState, *,
                           step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the newest (or ``step``) checkpoint of a
    ``CheckpointManager`` directory into ``trainer`` and ``state``, in
    place; returns the restored ``TrainState``, or None when the directory
    holds no committed checkpoint yet (the first start of a job: keep the
    fresh state). Every rank calls it."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        get_state_dict,
        set_state_dict,
    )

    with CheckpointManager(directory) as mgr:
        if step is None:
            step = mgr.latest_step()
            if step is None:
                return None
        sd = mgr.restore(get_state_dict(trainer, state), step=step)
    return set_state_dict(trainer, state, sd)


def reshard_state(state, shardings, *, max_staging_bytes=None):
    """Move a live state onto ``shardings`` without a checkpoint.

    ``state`` is a flat ``{fqn: value}`` dict in the checkpoint's names
    (``checkpoint.get_state_dict``): a ``DTensor`` (a rank's block and its
    placement), a whole tensor every rank holds, or None where this rank
    holds nothing. ``shardings`` maps the same names to a
    ``redistribute.Sharding`` on the new mesh (a mesh over the surviving
    ranks, ``init_device_mesh(..., ranks=...)``) or None, which leaves the
    value as it is. Every rank of the old and the new mesh calls it.
    Returns ``{fqn: this rank's block}`` (None outside the new mesh),
    which loads into a trainer built on the new mesh through
    ``checkpoint.set_state_dict``. Each leaf is one all-gather /
    all-to-all / dynamic-slice / device_put step, its peak a source block
    plus a destination block (and one staging chunk of at most
    ``max_staging_bytes`` across rank sets), never a gathered replica.
    """
    from pytorch_distributed_tpu_torch.redistribute import redistribute_tree

    return redistribute_tree(state, shardings,
                             max_staging_bytes=max_staging_bytes)


_LAYER = re.compile(r"^(model|optim)/([^./]+)\.(\d+)\.(.+)$")


def _layer_key(key: str, strategy):
    """``(stem, layer, kind, rest)`` of a pipeline stage's entry
    (``model/h.3.mlp.c_fc.weight`` -> ``("h", 3, "model",
    "mlp.c_fc.weight")``), else None."""
    m = _LAYER.match(key)
    if m is None or m.group(2) not in strategy.stage_param_keys:
        return None
    return m.group(2), int(m.group(3)), m.group(1), m.group(4)


def _stage_sharding(strategy, layer: int, n_layer: int, ndim: int):
    """Layer ``layer`` of ``n_layer`` whole on the ranks of the stage that
    holds it under ``strategy`` (``GPT2Pipe``'s cut: ``L/S`` consecutive
    layers a stage)."""
    from pytorch_distributed_tpu_torch.redistribute import Sharding
    from pytorch_distributed_tpu_torch.redistribute.plan import LocalMesh

    if n_layer % strategy.n_stages:
        raise ValueError(f"{n_layer} layers do not split into "
                         f"pp={strategy.n_stages} stages")
    stage = layer // (n_layer // strategy.n_stages)
    mesh = LocalMesh(strategy.mesh.device, ranks=strategy.stage_ranks(stage))
    return Sharding(mesh, [()] * ndim)


def placed_state(trainer, state: TrainState):
    """``checkpoint.get_state_dict(trainer, state)`` with every key on
    every rank: the source of :func:`reshard_state`.

    Under ``PipelineParallel`` a rank's state dict holds its own stage's
    layers only; here every layer's entries (``model/h.{i}.*`` and their
    optimizer state) are ``redistribute.Placed`` values, the layer whole
    on the ranks of its stage (the rank's tensor there, None elsewhere),
    so that every rank plans the same moves. Other strategies' state
    dicts are returned as they are."""
    from pytorch_distributed_tpu_torch.checkpoint import get_state_dict
    from pytorch_distributed_tpu_torch.redistribute import Placed

    sd = get_state_dict(trainer, state)
    strategy = trainer.strategy
    if not getattr(strategy, "pipeline_parallel", False):
        return sd
    n_layer = trainer.model.cfg.n_layer
    out, like = {}, {}
    for key, value in sd.items():
        parsed = _layer_key(key, strategy)
        if parsed is None:
            out[key] = value
        else:
            stem, _, kind, rest = parsed
            like[stem, kind, rest] = value
    for (stem, kind, rest), t in like.items():
        for i in range(n_layer):
            key = f"{kind}/{stem}.{i}.{rest}"
            out[key] = Placed(sd.get(key), _stage_sharding(
                strategy, i, n_layer, t.dim()), tuple(t.shape), t.dtype)
    return out


def _placement(strategy, kind: str, name: str, shape) -> Dict[str, int]:
    """``{axis: dim}`` of ``model/<name>`` (``kind`` "model") or of an
    optimizer tensor of the parameter's shape (``kind`` "optim") under
    ``strategy``."""
    if getattr(strategy, "tensor_parallel", False):
        placement = strategy.placement(name, shape)
        style = strategy.style_for(name)
        if getattr(style, "chunks", 1) > 1:
            # a fused projection's tp block is no one Shard: its state
            # dict entry is gathered whole over tp
            placement.pop(strategy.tp_axis, None)
        return placement
    param_axis = strategy.param_axis or getattr(strategy, "ep_axis", None)
    if kind == "optim" and strategy.update_axis is not None:
        # a strategy with an update axis holds the optimizer state in the
        # update layout (the trainer's ``layout``)
        dim = strategy.update_pspec(name, shape)
        return {} if dim is None else {strategy.update_axis: dim}
    if param_axis is None:
        return {}
    dim = strategy.param_pspec(name, shape)
    return {} if dim is None else {param_axis: dim}


def state_shardings(state, strategy):
    """The ``redistribute.Sharding`` of each value of ``state`` (a flat
    dict in the checkpoint's names: ``checkpoint.get_state_dict``'s, or
    :func:`placed_state`'s for a pipeline) where a trainer under
    ``strategy`` (built on the new mesh) holds it: the target of
    :func:`reshard_state`. Every strategy of the port has one:

    * ``model/<name>`` is cut where the strategy places the parameter:
      ``param_pspec`` over ``param_axis`` (FSDP's and HSDP's blocks,
      ``ExpertDataParallel``'s expert stacks over ``ep_axis``);
      ``TensorParallel``'s ``placement`` (its tp block, and under TP x
      FSDP its fsdp block on another dim; an ``ExpertParallel`` stack on
      its expert dim over tp), except a fused ``c_attn`` (``chunks`` > 1),
      whose weight, bias and moments are whole on every rank, as
      ``get_state_dict`` saves them (``set_state_dict`` cuts them into the
      rank's per-head rows);
    * ``optim/<name>/<key>`` where its optimizer state lives:
      ``update_pspec`` over ``update_axis`` where the strategy has one
      (FSDP's blocks, ZeRO1's), else beside the parameter;
    * under ``PipelineParallel`` the stage layers (``model/h.{i}.*`` and
      their optimizer state) whole on the ranks of the stage that holds
      layer ``i`` on the new mesh, and absent elsewhere; ``state`` must
      hold every layer (:func:`placed_state`);
    * every other value (the step count, the scaler, Adam's step, a
      replicated parameter, a pipeline's tables) is whole on every rank
      of the mesh.

    Every value must be a tensor (a DTensor, or a whole tensor) or a
    ``redistribute.Placed``."""
    from pytorch_distributed_tpu_torch.redistribute import Placed, Sharding

    mesh = getattr(strategy, "mesh", None)
    if mesh is None:
        raise ValueError(f"state_shardings: {type(strategy).__name__} has no "
                         "mesh to place the state on")
    pipeline = getattr(strategy, "pipeline_parallel", False)
    if pipeline:
        layers = {parsed[1] for parsed in (_layer_key(k, strategy)
                                           for k in state) if parsed}
        n_layer = max(layers) + 1 if layers else 0
        if layers != set(range(n_layer)):
            raise ValueError(
                f"state_shardings: the state holds layers {sorted(layers)}, "
                "not all of them: pass placed_state(trainer, state)")
    out = {}
    for key, value in state.items():
        if not isinstance(value, (torch.Tensor, Placed)):
            raise ValueError(f"state_shardings: {key} is {type(value)}, not "
                             "a tensor")
        shape = tuple(value.shape)
        layer = _layer_key(key, strategy) if pipeline else None
        if layer is not None:
            out[key] = _stage_sharding(strategy, layer[1], n_layer,
                                       len(shape))
            continue
        kind, _, rest = key.partition("/")
        name, _, leaf = rest.rpartition("/") if kind == "optim" else (rest,
                                                                      "", "")
        placement = {}
        if shape and kind in ("model", "optim"):
            placement = _placement(strategy, kind, name, shape)
        out[key] = Sharding.from_placement(mesh, placement, len(shape))
    return out
