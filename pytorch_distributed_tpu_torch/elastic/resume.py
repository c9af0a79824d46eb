"""Elastic resume onto the current world.

Port of ``pytorch_distributed_tpu/elastic/resume.py``. When the agent
restarts its workers (after a failure or a change of membership), each new
process builds its trainer on the world that exists now, which need not be
the one the newest checkpoint was written on. :func:`resume_from_checkpoint`
restores that checkpoint into the new trainer's live tensors in place,
resharding through ``torch.distributed.checkpoint`` (each rank reads its
own slice of whatever layout was saved).

:func:`reshard_state`, the no-disk move of a live state onto a new layout,
needs the redistribution planner (ROADMAP A.16) and raises.
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
    """Move a live state onto new shardings without a checkpoint."""
    raise NotImplementedError(
        "not ported yet: reshard_state (planned transfers of a live state "
        "onto a new layout): ROADMAP A.16")
