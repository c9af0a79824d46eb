"""Sharded, resumable checkpoints over ``torch.distributed.checkpoint``.

Port of ``pytorch_distributed_tpu/checkpoint/saver.py``, which wraps
orbax. Here DCP does the work (``dcp.save``/``dcp.load``/``dcp.async_save``
with ``FileSystemWriter``/``FileSystemReader``): every rank writes its own
blocks, the coordinator writes the metadata last, and a load reads each
rank's slice of whatever layout was saved, so a checkpoint moves between
strategies and world sizes (the DTensor views of ``state_dict.py``).

* **Atomic commit.** A checkpoint is written into a hidden temporary
  directory beside its final name and renamed once every rank has
  finished (DCP's last collective returns on every rank only after the
  metadata is written). A process killed during a save leaves only the
  temporary directory, which :meth:`CheckpointManager.latest_step` never
  returns.
* **Restore in place.** Loading writes into the tensors of the state dict
  it is given (``get_state_dict``'s views of the live tensors): nothing
  moves, so a runner keeps its captured step.
* **Async save.** ``dcp.async_save`` copies the state to host memory before
  it returns (the stall the step loop sees) and writes from a background
  thread; the commit follows when the write ends.
* Without a process group, DCP runs in one process. With one, the DCP
  calls run over a gloo group of their own (async save needs a CPU
  backend, and its background collectives must not interleave with the
  training step's on the default group).

Checkpoint directories are ``<directory>/<step>`` (temporary:
``<directory>/.tmp-<step>``).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from pytorch_distributed_tpu_torch.checkpoint.state_dict import load_model_state

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_params",
    "async_save_checkpoint",
    "CheckpointManager",
]

_METADATA = ".metadata"


def _tmp_path(path: str) -> str:
    head, tail = os.path.split(os.path.abspath(path))
    return os.path.join(head, f".tmp-{tail}")


def _group():
    """A gloo group for DCP's collectives, or None without a process
    group (a collective call: every rank makes it, in the same order)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.new_group(backend="gloo")


def _drop(group) -> None:
    if group is not None:
        dist.destroy_process_group(group)


def _is_coordinator(group) -> bool:
    return group is None or dist.get_rank(group) == 0


def _commit(path: str) -> None:
    """Rename the finished temporary directory to ``path``."""
    tmp = _tmp_path(path)
    if not os.path.exists(os.path.join(tmp, _METADATA)):
        raise RuntimeError(f"checkpoint {tmp} has no metadata: not committed")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _start(path: str, group) -> str:
    """Clear a torn temporary directory of ``path`` (the coordinator, before
    it enters DCP's first collective: no rank writes before that)."""
    tmp = _tmp_path(path)
    if _is_coordinator(group):
        shutil.rmtree(tmp, ignore_errors=True)
    return tmp


def _save(path: str, state_dict: Dict[str, Any], group) -> None:
    tmp = _start(path, group)
    dcp.save(state_dict, storage_writer=dcp.FileSystemWriter(tmp),
             process_group=group, no_dist=group is None)
    if _is_coordinator(group):
        _commit(path)
    if group is not None:
        dist.barrier(group)


class PendingSave:
    """An async save in flight: :meth:`wait_until_finished` blocks until it
    is written and committed (raising what the write raised)."""

    def __init__(self, path: str, handle, group, own_group: bool = False):
        self.path, self.group, self._own_group = path, group, own_group
        # newer DCP returns a response holding the upload's future
        self._future = getattr(handle, "upload_completion", handle)
        self._done = False

    def wait_until_finished(self) -> None:
        if self._done:
            return
        self._future.result()
        self._done = True
        if _is_coordinator(self.group):
            _commit(self.path)
        if self.group is not None:
            dist.barrier(self.group)
        if self._own_group:
            _drop(self.group)


def _async_save(path: str, state_dict: Dict[str, Any], group,
                own_group: bool = False) -> PendingSave:
    tmp = _start(path, group)
    handle = dcp.async_save(state_dict,
                            storage_writer=dcp.FileSystemWriter(tmp),
                            process_group=group, no_dist=group is None)
    return PendingSave(path, handle, group, own_group)


def save_checkpoint(path: str, state_dict: Dict[str, Any]) -> None:
    """Blocking sharded save of ``state_dict`` (e.g. ``get_state_dict``'s)
    to the directory ``path``, committed atomically. Every rank calls it."""
    group = _group()
    try:
        _save(path, state_dict, group)
    finally:
        _drop(group)


def async_save_checkpoint(path: str, state_dict: Dict[str, Any]
                          ) -> PendingSave:
    """Non-blocking save: the state is copied to host memory before this
    returns and written in the background. Call ``.wait_until_finished()``
    before relying on the files."""
    return _async_save(path, state_dict, _group(), own_group=True)


def load_checkpoint(path: str, state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Load the checkpoint at ``path`` into ``state_dict``'s tensors in
    place, resharding to their layout; returns ``state_dict``."""
    group = _group()
    try:
        return _load(path, state_dict, group)
    finally:
        _drop(group)


def _load(path, state_dict, group):
    if not os.path.exists(os.path.join(path, _METADATA)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    dcp.load(state_dict, storage_reader=dcp.FileSystemReader(path),
             process_group=group, no_dist=group is None)
    return state_dict


def load_params(directory: str, model, *, step: Optional[int] = None,
                strategy=None) -> int:
    """Load only the ``model/...`` entries of a :class:`CheckpointManager`
    checkpoint (default: the latest) into ``model`` in place, resharding
    onto ``strategy``'s layout; the optimizer state is never read. Returns
    the step loaded."""
    with CheckpointManager(directory) as mgr:
        return mgr.restore_params(model, step=step, strategy=strategy)


class CheckpointManager:
    """Step-numbered checkpoints with keep-last-``max_to_keep`` and resume
    from the newest committed one.

    ``save(step, state_dict)`` writes ``<directory>/<step>`` (in the
    background with ``async_save``: a save waits for the one before it);
    ``restore(state_dict, step=None)`` loads the newest (or ``step``) into
    ``state_dict`` in place. Every rank makes the manager and calls
    ``save``/``restore``/``wait_until_finished``/``close`` together.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._group = _group()
        self._pending: Optional[PendingSave] = None
        if _is_coordinator(self._group):
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.exists(os.path.join(self.directory, n,
                                                      _METADATA)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state_dict: Dict[str, Any]) -> bool:
        """Save ``state_dict`` as ``step``; False (nothing written) when
        that step is committed already."""
        self.wait_until_finished()
        if step in self.all_steps():
            return False
        if self.async_save:
            self._pending = _async_save(self._path(step), state_dict,
                                        self._group)
        else:
            _save(self._path(step), state_dict, self._group)
            self._prune()
        return True

    def wait_until_finished(self) -> None:
        """Block until the async save in flight (if any) is committed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.wait_until_finished()
            self._prune()

    def _prune(self) -> None:
        if not _is_coordinator(self._group):
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def _step_or_latest(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        return step

    def restore(self, state_dict: Dict[str, Any], *,
                step: Optional[int] = None) -> Dict[str, Any]:
        """Load ``step`` (default: the newest) into ``state_dict`` in
        place, resharding onto its layout; returns ``state_dict``."""
        return _load(self._path(self._step_or_latest(step)), state_dict,
                     self._group)

    def restore_params(self, model, *, step: Optional[int] = None,
                       strategy=None) -> int:
        """Load only the model's entries of ``step`` (default: the newest)
        into ``model`` in place; returns the step."""
        step = self._step_or_latest(step)
        path = self._path(step)
        load_model_state(model, strategy,
                         lambda sd: _load(path, sd, self._group))
        return step

    def close(self) -> None:
        self.wait_until_finished()
        _drop(self._group)
        self._group = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
