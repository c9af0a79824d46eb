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
     state never;
  5. :func:`reshard_gpt2_params` moves live weights (a trainer's FSDP
     blocks, another serving layout, a state dict on the host) onto the
     serving layout through one planned transfer per parameter
     (``redistribute``), and ``InferenceEngine.swap_params`` moves new
     weights onto the engine's own placement the same way.

The fused ``c_attn``'s per-head block (a rank's rows of each of q, k, v) is
not one ``Shard(dim)`` of ``[3C, C]``: a load reads its weight and bias
whole and cuts them (ROADMAP C), and a planned move takes q, k and v as
three leaves, each one transfer of its own ``[C, C]`` rows.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

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
    from pytorch_distributed_tpu_torch.checkpoint.state_dict import (
        _Entry,
        _view,
    )

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
            state[key] = _view(_Entry(t, {tp_axis: spec.dim}), placed)
        else:
            whole = torch.empty(spec.whole, dtype=t.dtype, device=t.device)
            state[key] = whole
            cut.append((t, whole, spec))
    load_checkpoint(path, state)
    for t, whole, spec in cut:
        t.copy_(tp_block(whole, spec))
    return step


class _Src(NamedTuple):
    """One parameter's source: this rank's tensor ``x`` (None: it holds
    none), its ``Sharding`` (None: the whole tensor, on every rank), the
    global ``shape`` and ``dtype``, and ``chunked``: ``x`` is a fused
    projection's tp block (its rows of each of q, k, v), each part a block
    of its own leaf under ``sharding``."""
    x: Any
    sharding: Any
    shape: Tuple[int, ...]
    dtype: torch.dtype
    chunked: bool = False


class _Dst(NamedTuple):
    """One parameter's target: the ``whole`` shape and ``dtype``, its
    ``{axis: dim}`` ``placement`` on ``mesh``, and ``chunks`` > 1 for a
    fused projection (each part a leaf placed the same way)."""
    whole: Tuple[int, ...]
    dtype: torch.dtype
    mesh: Any
    placement: Dict[str, int]
    chunks: int = 1


def _sources(source, strategy=None) -> Dict[str, _Src]:
    """``{name: _Src}`` of a model (its parameters' blocks, placed on
    ``strategy.mesh`` by their ``fsdp``/``tp`` specs; needed for a sharded
    model) or of a state dict in the model's names (``model/`` prefixes
    dropped): DTensors and ``redistribute.Placed`` values carry their
    placement, tensors and numpy arrays are whole."""
    from pytorch_distributed_tpu_torch.redistribute import Placed, Sharding
    from pytorch_distributed_tpu_torch.redistribute.executor import (
        dtensor_sharding,
    )

    if not isinstance(source, torch.nn.Module):
        out = {}
        for name, v in source.items():
            name = name.removeprefix("model/")
            s = dtensor_sharding(v)
            if isinstance(v, Placed):
                out[name] = _Src(v.block, v.sharding, tuple(v.shape), v.dtype)
            elif s is not None:
                out[name] = _Src(v.to_local(), s, tuple(v.shape), v.dtype)
            else:
                v = torch.as_tensor(v)
                out[name] = _Src(v, None, tuple(v.shape), v.dtype)
        return out
    params = dict(source.named_parameters())
    mesh = getattr(strategy, "mesh", None)
    out = {}
    for name, t in source.state_dict().items():
        p = params.get(name)
        fsdp, tp = getattr(p, "fsdp", None), getattr(p, "tp", None)
        if (fsdp is not None or tp is not None) and mesh is None:
            raise ValueError(f"{name} is held sharded: pass the strategy "
                             "whose mesh places it")
        shape = list(tp.whole if tp is not None else t.shape)
        dims = {}
        if fsdp is not None:
            dims[strategy.param_axis] = fsdp.dim
            if tp is None:
                shape[fsdp.dim] *= fsdp.size
        if tp is not None:
            dims[strategy.tp_axis] = tp.dim
        sharding = (None if mesh is None else
                    Sharding.from_placement(mesh, dims, t.dim()))
        out[name] = _Src(t, sharding, tuple(shape), t.dtype,
                         tp is not None and tp.chunks > 1)
    return out


def _check_sources(sources: Dict[str, _Src], targets: Dict[str, _Dst],
                   what: str) -> None:
    """The same names as ``targets``, each of the whole shape and the
    dtype, or ``ValueError`` (before anything moves)."""
    if set(sources) != set(targets):
        missing = sorted(set(targets) - set(sources))
        extra = sorted(set(sources) - set(targets))
        raise ValueError(
            f"swap_params: {what} structure mismatch -- missing "
            f"{missing[:4]}, unexpected {extra[:4]}")
    for name, dst in targets.items():
        src = sources[name]
        if src.shape != tuple(dst.whole) or src.dtype != dst.dtype:
            raise ValueError(
                f"swap_params: leaf mismatch at {what} {name!r} -- have "
                f"{tuple(dst.whole)}/{dst.dtype}, got "
                f"{src.shape}/{src.dtype}")


def _move_params(sources: Dict[str, _Src], targets: Dict[str, _Dst], *,
                 outs: Optional[Dict[str, torch.Tensor]] = None,
                 max_staging_bytes: Optional[int] = None):
    """One planned transfer per parameter (three for a fused projection)
    from ``sources`` onto ``targets``; writes into ``outs[name]`` where
    given (in place), else into new blocks. Returns ``({name: block},
    TransferCost)``; every rank of the sources' and targets' meshes calls
    it."""
    from pytorch_distributed_tpu_torch.redistribute import (
        Sharding,
        TransferCost,
        execute_plan,
        plan_transfer,
    )

    blocks, cost = {}, TransferCost(0, 0, 0)
    for name in sorted(targets):
        src, dst = sources[name], targets[name]
        ndim = len(dst.whole)
        sharding = Sharding.from_placement(dst.mesh, dst.placement, ndim)
        out = outs.get(name) if outs is not None else None
        if dst.chunks == 1:
            plan = plan_transfer(dst.whole, dst.dtype, src.sharding,
                                 sharding, max_staging_bytes=max_staging_bytes)
            blocks[name] = execute_plan(src.x, plan, out=out, name=name)
            cost = cost + plan.cost
            continue
        # a fused projection: q, k and v are leaves of their own
        (d,) = set(dst.placement.values())
        k = dst.chunks
        part = list(dst.whole)
        part[d] //= k
        held = list(dst.whole)
        for axis, dim in dst.placement.items():
            held[dim] //= dst.mesh.size(axis)
        if out is None:
            device = getattr(dst.mesh, "device", None) or src.x.device
            out = torch.empty(held, dtype=dst.dtype, device=device)
        rows = held[d] // k
        for j in range(k):
            x, region = src.x, None
            if src.chunked:
                if x is not None:
                    step = x.shape[d] // k
                    x = x.narrow(d, j * step, step)
            elif src.sharding is None:
                x = x.narrow(d, j * part[d], part[d])
            else:   # every rank, holding a block or not, plans the window
                offset = [0] * ndim
                offset[d] = j * part[d]
                region = (dst.whole, tuple(offset))
            plan = plan_transfer(part, dst.dtype, src.sharding, sharding,
                                 max_staging_bytes=max_staging_bytes,
                                 region=region)
            execute_plan(x, plan, out=out.narrow(d, j * rows, rows),
                         name=f"{name}[{j}]")
            cost = cost + plan.cost
        blocks[name] = out
    return blocks, cost


def _serving_targets(sources, mesh, tp_axis, dp_axis):
    strategy = _strategy(mesh, tp_axis, dp_axis)
    targets = {}
    for name, src in sources.items():
        placement = strategy.placement(name, src.shape)
        style = strategy.style_for(name)
        chunks = getattr(style, "chunks", 1) if placement else 1
        targets[name] = _Dst(src.shape, src.dtype, mesh, placement, chunks)
    return targets


@torch.no_grad()
def reshard_gpt2_params(model_or_state, mesh: DeviceMesh, *,
                        strategy=None, tp_axis: str = "tp",
                        dp_axis: Optional[str] = "dp",
                        max_staging_bytes: Optional[int] = None,
                        with_cost: bool = False):
    """Move live weights onto the serving layout of ``mesh`` without a
    checkpoint: this rank's blocks of :func:`gpt2_param_shardings`.

    The source is a model (a trainer's, with its ``strategy`` when it
    holds blocks: FSDP, TP, TP x FSDP) or a state dict in the model's
    names (DTensors on any mesh, or whole tensors on every rank: a file
    read on the host). Every parameter goes through one planned transfer
    (``redistribute``: all-gather / all-to-all / dynamic-slice /
    device_put, its peak a source block plus a destination block, never
    gather-then-slice), the fused ``c_attn`` through three, one for each
    of q, k and v. Every rank of both meshes calls it. Returns ``{name:
    block}`` (the state a model cut by :func:`shard_gpt2_params` holds:
    load it, or hand it to ``InferenceEngine.swap_params``), and the
    planner's ``TransferCost`` beside it with ``with_cost``.
    """
    sources = _sources(model_or_state, strategy)
    targets = _serving_targets(sources, mesh, tp_axis, dp_axis)
    blocks, cost = _move_params(sources, targets,
                                max_staging_bytes=max_staging_bytes)
    return (blocks, cost) if with_cost else blocks
