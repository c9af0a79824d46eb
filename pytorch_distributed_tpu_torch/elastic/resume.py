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
moments on the new ep size, FSDP's blocks on the new fsdp size).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.parallel.state import TrainState

__all__ = ["resume_from_checkpoint", "reshard_state", "state_shardings"]


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


def state_shardings(state, strategy):
    """The ``redistribute.Sharding`` of each value of ``state`` (a flat
    dict in the checkpoint's names, ``checkpoint.get_state_dict``'s) where
    a trainer under ``strategy`` (built on the new mesh) holds it: the
    target of :func:`reshard_state`.

    ``model/<name>`` is cut where the strategy places the parameter
    (``param_pspec``: ``ExpertDataParallel``'s expert stacks on their
    expert dim over ``ep_axis``, FSDP's and HSDP's blocks over
    ``param_axis``), ``optim/<name>/<key>`` where its optimizer state
    lives (``update_pspec`` over ``update_axis`` where the strategy has
    one: FSDP's blocks, ZeRO1's; else beside the parameter), and every other
    value (the step count, the scaler, Adam's step, a replicated
    parameter) is whole on every rank of the mesh. Every value must be a
    tensor (a DTensor, or a whole tensor). Tensor and pipeline
    parallelism's layouts are not among them: a fused ``c_attn`` is
    saved whole over tp, and a pipeline moves whole layers (ROADMAP
    A.14e)."""
    from pytorch_distributed_tpu_torch.redistribute import Sharding

    if getattr(strategy, "tensor_parallel", False) or getattr(
            strategy, "pipeline_parallel", False):
        raise NotImplementedError(
            f"state_shardings: {type(strategy).__name__}'s layout is not "
            "one Shard per tensor (a fused c_attn is saved whole over tp; a "
            "pipeline moves whole layers: ROADMAP A.14e)")
    mesh = getattr(strategy, "mesh", None)
    if mesh is None:
        raise ValueError(f"state_shardings: {type(strategy).__name__} has no "
                         "mesh to place the state on")
    param_axis = strategy.param_axis or getattr(strategy, "ep_axis", None)
    # a strategy with an update axis holds the optimizer state in the
    # update layout (the trainer's ``layout``)
    sharded = strategy.update_axis is not None
    update_axis = strategy.update_axis if sharded else param_axis
    out = {}
    for key, value in state.items():
        if not isinstance(value, torch.Tensor):
            raise ValueError(f"state_shardings: {key} is {type(value)}, not "
                             "a tensor")
        shape = tuple(value.shape)
        kind, _, rest = key.partition("/")
        name, _, leaf = rest.rpartition("/") if kind == "optim" else (rest,
                                                                      "", "")
        placement = {}
        if shape and kind == "model" and param_axis is not None:
            dim = strategy.param_pspec(name, shape)
            placement = {} if dim is None else {param_axis: dim}
        elif shape and kind == "optim" and update_axis is not None:
            pspec = (strategy.update_pspec if sharded
                     else strategy.param_pspec)
            dim = pspec(name, shape)
            placement = {} if dim is None else {update_axis: dim}
        out[key] = Sharding.from_placement(mesh, placement, len(shape))
    return out
