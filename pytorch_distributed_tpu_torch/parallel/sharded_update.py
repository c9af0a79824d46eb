"""The sharded weight update: gradients into the update layout, the
optimizer on the shard, the new values back.

Port of ``pytorch_distributed_tpu/parallel/sharded_update.py``, the engine
behind ``strategy.sharded_update`` (``ZeRO1``, FSDP): the cross-replica
sharded weight update of arXiv 2004.13336. Where the reference writes
three sharding constraints into its one jitted step and lets SPMD place
the collectives, the port issues them (``parallel.comm``):

    grads        --shard_grads-->           reduce-scatter (ZeRO1), or the
                                            FSDP shard's replica all-reduce
    opt step     on the 1/axis shard, beside its state shard
    new params   --apply_sharded_update-->  all-gather (ZeRO1; FSDP keeps
                                            the shard)

:class:`ShardedParams` holds the layout of one model under one strategy:
for every trainable parameter, the tensor the optimizer steps on (FSDP:
the parameter itself, held as its shard by ``parallel.fsdp``; ZeRO1: a
contiguous copy of the parameter's block; a parameter kept whole: itself)
and the dim of its update shard. ``Trainer.init`` builds it and re-points
the optimizer's parameter groups at those tensors, so the user's optimizer
(its class, its hyperparameters, its groups) steps on the shards and its
state is created on them. ZeRO1 gathers the new shard values, not the
update as the reference does: the reference gathers the delta to keep
``p + u`` out of an XLA fusion that changed its last bit; in torch the
elementwise step on a block computes each element as on the whole tensor,
so the gathered values are the unsharded update's, bit for bit.

Every gradient is averaged over the batch ranks (divided by
``data_shard_count``, DP's mean). A parameter kept whole gets its
gradient all-reduced (one flat buffer for all of them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.parallel.fsdp import (
    Shard,
    gather,
    local_block,
    reduce_scatter,
    shard_module,
)

__all__ = [
    "ShardedParams",
    "update_pspecs",
    "param_pspecs",
    "shard_grads",
    "apply_sharded_update",
]


def update_pspecs(strategy, model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """``{name: dim}`` of the weight-update layout (None: whole), over the
    whole parameters' torch shapes."""
    return {n: strategy.update_pspec(n, tuple(p.shape))
            for n, p in model.named_parameters()}


def param_pspecs(strategy, model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """``{name: dim}`` of the resident parameter layout."""
    return {n: strategy.param_pspec(n, tuple(p.shape))
            for n, p in model.named_parameters()}


@dataclasses.dataclass
class Leaf:
    name: str
    param: torch.nn.Parameter
    #: what the optimizer steps on (the parameter, or ZeRO1's block)
    tensor: torch.Tensor
    #: FSDP: the parameter is held sharded; ZeRO1: its update is
    param_shard: Optional[Shard] = None
    update_shard: Optional[Shard] = None

    @property
    def sharded(self) -> bool:
        return self.param_shard is not None or self.update_shard is not None


class ShardedParams:
    """The layout of ``model``'s trainable parameters under ``strategy``,
    made at start-up (after ``strategy.sync_params``): FSDP's parameters
    cut to their shards, ZeRO1's update blocks made, and ``optimizer``
    re-pointed at the tensors it steps on. Create the optimizer state
    after this (``Trainer.init`` does)."""

    def __init__(self, strategy, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer):
        if any(optimizer.state.values()):
            raise ValueError("the optimizer has state already: the sharded "
                             "layout is made before its state")
        self.strategy = strategy
        self.n_batch = strategy.data_shard_count
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        update_dims = {n: strategy.update_pspec(n, tuple(p.shape))
                       for n, p in params.items()}
        param_shards = (shard_module(model, strategy)
                        if strategy.param_axis is not None else {})
        axis = strategy.update_axis
        self.leaves: List[Leaf] = []
        for name, p in params.items():
            if name in param_shards:
                self.leaves.append(Leaf(name, p, p,
                                        param_shard=param_shards[name]))
            elif update_dims[name] is not None and axis != strategy.param_axis:
                size = strategy.mesh.size(axis)
                rank = strategy.mesh.get_local_rank(axis)
                dim = update_dims[name]
                spec = Shard(dim, strategy.shard_group, rank, size)
                block = local_block(p.detach(), dim, rank, size)
                self.leaves.append(Leaf(name, p, block, update_shard=spec))
            else:
                self.leaves.append(Leaf(name, p, p))
        swap = {id(leaf.param): leaf.tensor for leaf in self.leaves}
        for group in optimizer.param_groups:
            group["params"] = [swap.get(id(p), p) for p in group["params"]]

    @property
    def tensors(self) -> List[torch.Tensor]:
        """The tensors the optimizer steps on, in ``model.parameters()``
        order."""
        return [leaf.tensor for leaf in self.leaves]

    def spec(self, name: str) -> Optional[Shard]:
        """How the optimizer's tensor (and state) for ``name`` is cut."""
        leaf = next(x for x in self.leaves if x.name == name)
        return leaf.param_shard or leaf.update_shard


@torch.no_grad()
def shard_grads(layout: ShardedParams, grads: List[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Fresh gradients (one per leaf: FSDP's already the group's sum over
    the shard, the others this rank's whole gradient) in the update
    layout, averaged over the batch ranks:

    * FSDP shard: all-reduced over the shard's replicas (the ``dp`` or
      ``dcn`` axis), if there are any;
    * ZeRO1 with ``sharded_update``: reduce-scattered into the block
      (this replaces DP's all-reduce);
    * ZeRO1 without it: DP's one flat all-reduce, then this rank's block;
    * kept whole: one flat all-reduce of all of them.

    Placed right after the gradients are computed, so that the unscale,
    the all-finite check, the norm and the clip run on the shards."""
    st, n = layout.strategy, layout.n_batch
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    whole = []
    if not st.sharded_update:
        # ZeroRedundancyOptimizer: DP's reduction, the whole gradients
        return st.reduce_grads(grads)
    for i, (leaf, g) in enumerate(zip(layout.leaves, grads)):
        if leaf.param_shard is not None:
            g = g.float()
            if st.shard_replicas is not None:
                comm.all_reduce(g, st.shard_replicas)
            out[i] = (g / n).to(leaf.tensor.dtype)
        elif leaf.update_shard is not None:
            spec = leaf.update_shard
            g = reduce_scatter(g.float(), spec.dim, spec.group, spec.size)
            out[i] = (g / n).to(leaf.tensor.dtype)
        else:
            whole.append(i)
    if whole:
        flat = torch.cat([grads[i].reshape(-1).float() for i in whole])
        comm.all_reduce(flat, st.group)
        flat /= n
        for i, new in zip(whole, flat.split([grads[i].numel()
                                             for i in whole])):
            out[i] = new.view_as(grads[i]).to(grads[i].dtype)
    return out


@torch.no_grad()
def grad_norm_and_finite(layout: ShardedParams, grads: List[torch.Tensor],
                         finite: torch.Tensor):
    """The global norm of the update-layout gradients and the all-finite
    flag over every rank, from one all-reduce of two numbers on the
    device over the shard group (no host read): a block's sum of squares
    counts once per shard group, so a whole gradient (equal on every
    rank) is summed here locally and a shard replicated over ``dp`` or
    ``dcn`` is not counted again there."""
    st = layout.strategy
    shard_sq = torch.zeros((), dtype=torch.float32, device=finite.device)
    whole_sq = 0
    for leaf, g in zip(layout.leaves, grads):
        sq = (g.float() * g.float()).sum()
        if leaf.sharded and st.sharded_update:
            shard_sq = shard_sq + sq
        else:
            whole_sq = whole_sq + sq
    if st.sharded_update:
        both = torch.stack([shard_sq, (~finite).float()])
        comm.all_reduce(both, st.shard_group)
        shard_sq, finite = both[0], both[1] == 0
    return torch.sqrt(whole_sq + shard_sq), finite


def _block(g: torch.Tensor, spec: Shard) -> torch.Tensor:
    return local_block(g, spec.dim, spec.rank, spec.size)


@torch.no_grad()
def apply_sharded_update(layout: ShardedParams, grads: List[torch.Tensor],
                         step) -> None:
    """The shard-local optimizer step: each tensor the optimizer steps on
    takes its gradient (ZeRO1 without ``sharded_update``: its block of the
    whole gradient), ``step()`` runs the optimizer (or the trainer's
    skip-on-inf step), and every ZeRO1 block is gathered back into its
    whole parameter (one gather per sharded-update leaf)."""
    for leaf, g in zip(layout.leaves, grads):
        if leaf.update_shard is not None and g.shape != leaf.tensor.shape:
            g = _block(g, leaf.update_shard)
        leaf.tensor.grad = g.to(leaf.tensor.dtype)
    step()
    for leaf in layout.leaves:
        spec = leaf.update_shard
        if spec is not None:
            leaf.param.copy_(gather(leaf.tensor, spec.dim, spec.group,
                                    spec.size))
