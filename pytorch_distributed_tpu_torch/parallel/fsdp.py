"""The sharded parameter of ``FullyShardedDataParallel``.

The reference has no such module: XLA's SPMD partitioner inserts the
gathers and the reduce-scatters where its sharding annotations say
(``pytorch_distributed_tpu/parallel/strategies.py``, the SimpleFSDP
mechanism of arXiv 2411.00284). Here they are written out, per parameter:

* :func:`shard_module` holds every parameter that the strategy shards as
  this rank's shard, in place: the same ``nn.Parameter`` object (the
  optimizer built over ``model.parameters()`` keeps pointing at it) with
  ``.data`` cut to its block along the shard dim (``p.fsdp``, a
  :class:`Shard`, says which). The module's class is swapped for a
  subclass in which that attribute is a property: reading
  ``module.weight`` returns :class:`Gather`'s output, the whole weight
  all-gathered over the FSDP group, so the model's code runs unchanged.
* :class:`Gather`'s backward reduce-scatters the whole weight's gradient
  into the shard: the sum over the group, which
  ``sharded_update.shard_grads`` turns into the batch mean. A parameter
  read twice (GPT-2's tied ``wte``: the embedding and the LM head) is
  gathered twice and its two gradient shards add up in ``p.grad``: one
  summed gradient shard.
* FULL_SHARD: no gathered weight lives from the forward to the backward.
  :func:`regather_saved` (the trainer holds it around the forward) is a
  ``saved_tensors_hooks`` pair: where autograd saves a gathered weight, or
  a dtype cast of one, or a view of either (``F.linear`` saves
  ``weight.t()`` of the compute-dtype copy), it keeps the shard and a
  recipe, and the backward gathers and casts again. Under ``remat`` the
  block's recompute gathers again by itself.

A shard along a dim other than 0 gathers into ``[n, ...]`` and moves that
axis into place: GPT-2's ``wte`` is ``[50257, 768]``, 50257 is odd, so it
shards along dim 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel import comm

__all__ = ["Shard", "Gather", "gather", "reduce_scatter", "shard_module",
           "full_tensor", "regather_saved", "local_block"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a sharded tensor's block sits: along ``dim``, block ``rank``
    of ``size`` over ``group``."""
    dim: int
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


def local_block(t: torch.Tensor, dim: int, rank: int, size: int
                ) -> torch.Tensor:
    """Block ``rank`` of ``size`` equal blocks of ``t`` along ``dim``, as a
    contiguous copy with storage of its own (a dim-0 block is contiguous
    already: ``.contiguous()`` would keep a view that holds the whole
    tensor's storage alive)."""
    return t.chunk(size, dim)[rank].clone(memory_format=torch.contiguous_format)


def gather(shard: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The whole tensor from every rank's block along ``dim``."""
    out = torch.empty((size * shard.shape[0], *shard.shape[1:]),
                      dtype=shard.dtype, device=shard.device)
    comm.all_gather(out, shard.contiguous(), group)
    if dim == 0:
        return out
    whole = list(shard.shape)
    whole[dim] *= size
    return out.view(size, *shard.shape).movedim(0, dim).reshape(whole)


def reduce_scatter(full: torch.Tensor, dim: int, group, size: int
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's
    ``full``."""
    shape = list(full.shape)
    shape[dim] //= size
    split = full.reshape(*full.shape[:dim], size, shape[dim],
                         *full.shape[dim + 1:]).movedim(dim, 0)
    out = torch.empty(shape, dtype=full.dtype, device=full.device)
    return comm.reduce_scatter(
        out, split.reshape(size * shape[0], *shape[1:]), group)


class Gather(torch.autograd.Function):
    """The whole weight from the shard parameter ``p`` (forward: all-gather
    over ``p.fsdp.group``), and the gradient's block of the group's sum
    (backward: reduce-scatter)."""

    @staticmethod
    def forward(ctx, p):
        spec: Shard = p.fsdp
        ctx.fsdp_src = p          # read by regather_saved's pack hook
        return gather(p.detach(), spec.dim, spec.group, spec.size)

    @staticmethod
    def backward(ctx, grad):
        spec: Shard = ctx.fsdp_src.fsdp
        return reduce_scatter(grad, spec.dim, spec.group, spec.size)


class _Regather:
    __slots__ = ("p", "dtype", "size", "stride", "offset")

    def __init__(self, p, dtype, size, stride, offset):
        self.p, self.dtype = p, dtype
        self.size, self.stride, self.offset = size, stride, offset


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    fn, dtype = base.grad_fn, None
    if fn is not None and type(fn).__name__ == "ToCopyBackward0":
        fn, dtype = fn.next_functions[0][0], base.dtype
    p = getattr(fn, "fsdp_src", None)
    if p is None or (dtype is not None and base.device != p.device):
        return t
    return _Regather(p, dtype, t.size(), t.stride(), t.storage_offset())


def _unpack(saved):
    if not isinstance(saved, _Regather):
        return saved
    spec: Shard = saved.p.fsdp
    whole = gather(saved.p.detach(), spec.dim, spec.group, spec.size)
    if saved.dtype is not None:
        whole = whole.to(saved.dtype)
    return whole.as_strided(saved.size, saved.stride, saved.offset)


def regather_saved():
    """Context for the forward: autograd keeps no gathered weight (see the
    module's docstring)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def _sharded_class(cls, names: Tuple[str, ...]):
    def prop(name):
        return property(lambda self: Gather.apply(self._parameters[name]))

    return type(f"FSDP{cls.__name__}", (cls,),
                {n: prop(n) for n in names})


@torch.no_grad()
def shard_module(model: torch.nn.Module, strategy) -> Dict[str, Shard]:
    """Hold every parameter of ``model`` that ``strategy.param_pspec``
    shards as this rank's block (in place; see the module's docstring).
    Returns ``{name: Shard}`` of the sharded ones."""
    group = strategy.shard_group
    size = strategy.mesh.size(strategy.param_axis)
    rank = strategy.mesh.get_local_rank(strategy.param_axis)
    out: Dict[str, Shard] = {}
    for mod_name, mod in model.named_modules():
        names = []
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            dim = strategy.param_pspec(full, tuple(p.shape))
            if dim is None:
                continue
            if hasattr(p, "fsdp"):
                raise ValueError(f"parameter {full} is sharded already")
            spec = Shard(dim, group, rank, size)
            p.data = local_block(p.data, dim, rank, size)
            p.fsdp = spec
            names.append(name)
            out[full] = spec
        if names:
            mod.__class__ = _sharded_class(type(mod), tuple(names))
    return out


def full_tensor(t: torch.Tensor, spec: Optional[Shard]) -> torch.Tensor:
    """The whole tensor from this rank's block (a copy of ``t`` if
    ``spec`` is None: it is whole already)."""
    if spec is None:
        return t.detach().clone()
    return gather(t.detach(), spec.dim, spec.group, spec.size)
