"""Distributed checkpoints of the port, over ``torch.distributed.checkpoint``.

Port of ``pytorch_distributed_tpu/checkpoint`` (DCP's ``save``/``load``/
``async_save``, reshard-on-load, FQN state dicts and the ``Stateful``
protocol, and a ``CheckpointManager`` with keep-last-k and resume from
the newest step), which the JAX package builds on orbax:

  * ``get_state_dict(trainer, state)`` / ``set_state_dict`` -- the flat
    ``model/...``, ``optim/...``, ``train/...`` dict of views of the live
    tensors, sharded ones as DTensors;
  * ``save_checkpoint`` / ``async_save_checkpoint`` / ``load_checkpoint``
    / ``load_params``;
  * ``CheckpointManager`` -- ``<directory>/<step>``, committed atomically.

Resuming a run::

    mgr = CheckpointManager(ckpt_dir, max_to_keep=3)
    sd = get_state_dict(trainer, state)
    if mgr.latest_step() is not None:
        state = set_state_dict(trainer, state, mgr.restore(sd))
    ...
    mgr.save(state.step, get_state_dict(trainer, state))
"""

from pytorch_distributed_tpu_torch.checkpoint.saver import (
    CheckpointManager,
    async_save_checkpoint,
    load_checkpoint,
    load_params,
    save_checkpoint,
)
from pytorch_distributed_tpu_torch.checkpoint.state_dict import (
    Stateful,
    get_state_dict,
    model_state_dict,
    set_state_dict,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_params",
    "async_save_checkpoint",
    "CheckpointManager",
    "get_state_dict",
    "set_state_dict",
    "model_state_dict",
    "Stateful",
]
