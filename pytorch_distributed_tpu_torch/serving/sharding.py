"""Train -> serve bridge: tensor-parallel serving weights from training
checkpoints.

Port of ``pytorch_distributed_tpu/serving/sharding.py``. Serving runs
Megatron TP over a ``(dp, tp)`` mesh: each tp rank holds its blocks of the
weights (``TensorParallel`` with ``gpt2_tp_plan``, on tp only; dp
replicates them) and the KV cache's heads of those blocks. Where the
reference answers with ``NamedSharding``s, the port answers as its
strategies do, with the dims that shard over the whole torch shapes:

  1. :func:`serving_mesh` is the inference mesh over the default process
     group's ranks (tp innermost);
  2. :func:`gpt2_param_shardings` (and :func:`draft_param_shardings`) give
     ``{name: {axis: dim}}`` from the plan the trainer uses, so the
     serving layout and the training TP layout cannot drift apart;
     :func:`shard_gpt2_params` cuts a model to a rank's blocks;
  3. :func:`kv_cache_sharding` and :func:`paged_kv_cache_sharding` put the
     heads of ``[L, S, T, H, D]`` and of ``[L, n_pages, page, H, D]`` on
     tp, which is what ``InferenceEngine(cache_sharding=...)`` takes;
  4. :func:`load_gpt2_params` reads only the ``model/...`` entries of a
     ``CheckpointManager`` directory, each rank its blocks, the optimizer
     state never.

The fused ``c_attn``'s per-head block (a rank's rows of each of q, k, v) is
not one ``Shard(dim)`` of ``[3C, C]``: its weight and bias are read whole
and cut (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Dict, Optional

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.mesh import DeviceMesh, init_device_mesh
from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    gpt2_tp_plan,
    tp_block,
)

__all__ = [
    "CacheSharding",
    "serving_mesh",
    "gpt2_param_shardings",
    "draft_param_shardings",
    "shard_gpt2_params",
    "kv_cache_sharding",
    "paged_kv_cache_sharding",
    "load_gpt2_params",
    "reshard_gpt2_params",
]

#: the heads dim of both caches' ``k``/``v``
HEAD_DIM = 3


def serving_mesh(*, dp: int = 1, tp: int = -1) -> DeviceMesh:
    """The ``(dp, tp)`` inference mesh over every rank of the default
    process group, tp innermost; ``-1`` infers an axis from the world."""
    world = dist.get_world_size()
    if tp == -1:
        tp = world // dp
    if dp == -1:
        dp = world // tp
    return init_device_mesh((dp, tp), ("dp", "tp"))


def _strategy(mesh, tp_axis, dp_axis) -> TensorParallel:
    return TensorParallel(mesh, gpt2_tp_plan(), tp_axis=tp_axis,
                          dp_axis=dp_axis)


def _whole_shapes(model):
    return {n: (p.tp.whole if hasattr(p, "tp") else tuple(p.shape))
            for n, p in model.named_parameters()}


def gpt2_param_shardings(model, mesh: DeviceMesh, *, tp_axis: str = "tp",
                         dp_axis: Optional[str] = "dp"
                         ) -> Dict[str, Dict[str, int]]:
    """``{name: {axis: dim}}`` of every parameter of ``model`` from the
    Megatron plan, on tp only (dp replicates the weights); ``{}`` is
    whole. Dims are of the whole torch shapes."""
    strategy = _strategy(mesh, tp_axis, dp_axis)
    return {n: strategy.placement(n, s)
            for n, s in _whole_shapes(model).items()}


def draft_param_shardings(draft_model, mesh: DeviceMesh, *,
                          tp_axis: str = "tp",
                          dp_axis: Optional[str] = "dp"
                          ) -> Dict[str, Dict[str, int]]:
    """The same plan for a separate speculative-decoding draft (a smaller
    GPT-2): its cache then takes :func:`kv_cache_sharding` unchanged."""
    return gpt2_param_shardings(draft_model, mesh, tp_axis=tp_axis,
                                dp_axis=dp_axis)


def shard_gpt2_params(model, mesh: DeviceMesh, *, tp_axis: str = "tp",
                      dp_axis: Optional[str] = "dp") -> TensorParallel:
    """Cut ``model`` (every rank holding the same whole weights) to this
    rank's blocks of :func:`gpt2_param_shardings`, in place; returns the
    strategy that did it."""
    strategy = _strategy(mesh, tp_axis, dp_axis)
    strategy.parallelize(model)
    return strategy


@dataclasses.dataclass(frozen=True)
class CacheSharding:
    """Where the K/V tensors shard: ``{cache dim: mesh axis}``."""
    mesh: DeviceMesh
    dims: Dict[int, str]

    @property
    def tp_axis(self) -> Optional[str]:
        return self.dims.get(HEAD_DIM)


def kv_cache_sharding(mesh: DeviceMesh, *, tp_axis: str = "tp",
                      dp_axis: Optional[str] = None) -> CacheSharding:
    """The slotted ``[L, S, T, H, D]`` cache: heads on tp (the colwise
    ``c_attn`` writes a rank's heads); optionally slots on dp."""
    dims = {HEAD_DIM: tp_axis}
    if dp_axis is not None:
        dims[1] = dp_axis
    return CacheSharding(mesh, dims)


def paged_kv_cache_sharding(mesh: DeviceMesh, *, tp_axis: str = "tp"
                            ) -> CacheSharding:
    """The paged ``[L, n_pages, page_size, H, D]`` pools: heads on tp, as
    the slotted cache. The pool is shared by every sequence, so there is
    no slot dim for dp; the block tables stay whole."""
    return CacheSharding(mesh, {HEAD_DIM: tp_axis})


@torch.no_grad()
def load_gpt2_params(ckpt_dir: str, model, mesh: Optional[DeviceMesh] = None,
                     *, step: Optional[int] = None, tp_axis: str = "tp",
                     dp_axis: Optional[str] = "dp") -> int:
    """Load serving weights from a training checkpoint directory into
    ``model`` in place; returns the step loaded (default: the newest).

    With ``mesh`` the model is cut to this rank's blocks first (unless it
    is already), and each rank reads its block of every parameter from the
    checkpoint (a ``DTensor`` view, ``Shard`` on tp), except ``c_attn``'s
    weight and bias, which are read whole and cut. Only the ``model/...``
    entries are read; the optimizer state is never."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )
    from pytorch_distributed_tpu_torch.checkpoint.state_dict import _view

    if mesh is not None and getattr(model, "tp", None) is None:
        shard_gpt2_params(model, mesh, tp_axis=tp_axis, dp_axis=dp_axis)
    with CheckpointManager(ckpt_dir) as mgr:
        step = mgr.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        path = os.path.join(mgr.directory, str(step))
    params = dict(model.named_parameters())
    placed = types.SimpleNamespace(mesh=mesh)    # what _view reads
    state, cut = {}, []
    for name, t in model.state_dict().items():
        spec = getattr(params.get(name), "tp", None)
        key = f"model/{name}"
        if spec is None:
            state[key] = t
        elif spec.chunks == 1:
            state[key] = _view((t, tp_axis, spec.dim), placed)
        else:
            whole = torch.empty(spec.whole, dtype=t.dtype, device=t.device)
            state[key] = whole
            cut.append((t, whole, spec))
    load_checkpoint(path, state)
    for t, whole, spec in cut:
        t.copy_(tp_block(whole, spec))
    return step


def reshard_gpt2_params(*args, **kwargs):
    """Move live weights onto a serving mesh without a checkpoint."""
    raise NotImplementedError(
        "not ported yet: reshard_gpt2_params (planned transfers of live "
        "weights onto the serving layout): ROADMAP A.16")
