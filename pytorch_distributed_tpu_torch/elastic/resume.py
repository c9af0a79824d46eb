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
planner, every leaf in one planned transfer.
"""

from __future__ import annotations

from typing import Optional

from pytorch_distributed_tpu_torch.parallel.state import TrainState

__all__ = ["resume_from_checkpoint", "reshard_state"]


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
