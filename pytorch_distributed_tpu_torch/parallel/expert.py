"""Expert parallelism: the mixture-of-experts MLP and its sharding.

Port of ``pytorch_distributed_tpu/parallel/expert.py``:

* :func:`make_dispatch_masks`: a top-k routing's dispatch and combine
  masks, queue positions taken jointly over the k slots, slot-major (every
  top-1 claim on an expert's capacity before any top-2 claim), so no two
  (token, slot) assignments share an (expert, position) cell; claims past
  the capacity are dropped;
* :class:`MoEMLP`: the Switch/GShard routed MLP (top-k of E experts per
  token, tokens routed within groups of ``group_size``, a per-expert
  capacity, the Switch load-balancing aux loss), with the reference's
  dense one-hot einsums for dispatch and combine (cuBLAS batched GEMMs
  here; the reference has no hand-written kernel for them either);
* :class:`ExpertParallel`: the style that shards an expert stack's
  leading ``[E]`` dim;
* :class:`ExpertDataParallel`: the strategy, DDP over ``dp`` with every
  expert stack sharded over ``ep``.

The one-hot of an index is built by comparison with ``arange`` (not
``F.one_hot``, which checks its range with a host read that a CUDA graph
capture cannot hold). The capacity is a host number from the config, so
the layer has static shapes and no host read: the runner captures it.

Expert parallelism's collectives, written out where the reference leaves
them to XLA (it lowers the dispatch contraction to an all-to-all). The
batch is split over ``dp`` only, so every ``ep`` rank of a dp row sees the
same tokens and computes the same router, top-k and masks; a rank holds
experts ``[e0, e1)`` and per MoE block runs Megatron's f/g pair
(``tensor_parallel._CopyIn``/``_ReduceOut``) over the ep group:

* f (identity forward, all-reduce of the gradient) on the tokens that
  enter the dispatch einsum ([n, C] a group) and on the gate values
  ([n, k]), not on the combine mask ([n, E, capacity]);
* the masks' columns ``[e0, e1)`` (an expert's queue positions depend on
  the tokens that chose it only, so the local columns are the whole
  masks' columns);
* the local experts, then the partial combine with an fp32 output;
* g: an all-reduce over ep in fp32, then the cast to the compute dtype.

So the gradient of every parameter outside the expert stacks is the same
on every ep rank, and the strategy averages all gradients over ``dp``
only. The wire a block is two f's in the backward and one g in the
forward (ROADMAP C). ``TensorParallel`` with ``ExpertParallel`` in its
plan runs the same pair over the tp group, or inside a sequence-parallel
region :class:`SequenceEPContext` (the reduce-scatter along T in place
of g; the block's gather of the sequence in place of f).

Under a data-parallel split (``DataParallel``, FSDP, this strategy) a
rank routes its own rows: ``group_size`` None is the rank's tokens, and a
routing group never spans two data shards. The aux loss's statistics (the
mean router probability and the top-1 fraction per expert) are those of
the global batch, as the reference's global-view step takes them: the
strategy sets ``stats_group`` (as it does a BatchNorm's), and the layer
averages them over it (an all-reduce of ``2 E`` numbers forward, and of
the gradient backward). So with routing groups inside the shards, the
losses are the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.parallel.fsdp import Shard, local_block
from pytorch_distributed_tpu_torch.parallel.strategies import (
    DataParallel,
    broadcast_tensors,
)
from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
    ParallelStyle,
    _CopyIn,
    _ReduceOut,
)

__all__ = ["EPContext", "ExpertDataParallel", "ExpertParallel", "MoEMLP",
           "SequenceEPContext", "make_dispatch_masks"]

#: flax's truncated normal: cut at two sigma, this restores unit variance
_TRUNC_STD = 0.87962566103423978


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes, by comparison (no host
    read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def make_dispatch_masks(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                        n_experts: int, capacity: int,
                        dtype: torch.dtype = torch.float32,
                        experts: Optional[Tuple[int, int]] = None):
    """Dispatch and combine masks from top-k routing decisions.

    Args:
      expert_idx: ``[G, n, k]`` int, the expert each token picked per slot.
      gate_vals: ``[G, n, k]`` float, the router's probability of it.
      n_experts, capacity: static sizes.
      experts: ``(e0, e1)``, the experts whose columns to build (an
        expert-parallel rank's); None builds all ``n_experts``.

    Returns ``dispatch`` ``[G, n, E, capacity]`` (0/1 in ``dtype``) and
    ``combine`` ``[G, n, E, capacity]`` (gate-weighted, fp32), ``E`` the
    experts built. Each cell holds at most one (token, slot) assignment,
    so both are exact in any summation order.
    """
    G, n, k = expert_idx.shape
    e0, e1 = experts or (0, n_experts)
    e_sm = expert_idx.transpose(1, 2).reshape(G, k * n)       # slot-major
    onehot = _one_hot(e_sm, n_experts)                        # [G, k n, E]
    pos = (torch.cumsum(onehot, dim=1) - onehot) * onehot
    pos_in_e = pos.sum(-1).to(torch.int32)                    # [G, k n]
    keep = pos_in_e < capacity
    # the overflow slot (position ``capacity``) is dropped
    pos_oh = _one_hot(torch.where(keep, pos_in_e, capacity), capacity)
    d = onehot[..., e0:e1, None] * pos_oh[..., None, :]       # [G, kn, E, c]
    d = d.reshape(G, k, n, e1 - e0, capacity)
    dispatch = d.sum(dim=1).to(dtype)
    combine = torch.einsum("gksec,gks->gsec", d, gate_vals.transpose(1, 2))
    return dispatch, combine


class EPContext:
    """What an expert-parallel MoE layer reads: the ep group, its size and
    this rank's coordinate; ``enter`` is f and ``exit`` is g."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)


class SequenceEPContext(EPContext):
    """Expert parallelism over the tp group inside a sequence-parallel
    region (``TensorParallel`` with ``ExpertParallel`` in its plan): the
    block hands the layer the sequence gathered along T (the gather's
    backward reduce-scatters the tokens' partial gradients, so ``enter``
    is the identity) and ``exit`` is the region's g, the reduce-scatter
    along T of the partial combine ``[B, T, C]`` (its backward
    all-gathers, so every rank's experts see every token's gradient)."""

    def __init__(self, tp):
        super().__init__(tp.group, tp.size, tp.rank)
        self.tp = tp

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.exit(x)


class _MeanOver(torch.autograd.Function):
    """The mean over ``group`` of every rank's ``x``, forward; the mean of
    the gradients, backward (each rank's loss holds the global statistic
    once, so the mean of their gradients is its gradient)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               group) / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return comm.all_reduce(g, ctx.group) / ctx.n, None, None


def _lecun_3d(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` on a 3-D ``[E, fan_in, fan_out]`` stack: the
    leading dim counts as a receptive field, so the fan-in is
    ``E * shape[1]``."""
    std = (w.shape[0] * w.shape[1]) ** -0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class MoEMLP(nn.Module):
    """Top-k routed mixture-of-experts MLP (the Switch transformer's shape).

    ``forward(x [B, T, C]) -> (out [B, T, C], {"aux_loss", "expert_fraction"})``:
    the router picks the top-k of E experts per token, tokens are dispatched
    up to a per-expert capacity, run through their experts' MLPs (GELU,
    tanh) and combined weighted by the router's probabilities. ``aux_loss``
    is the Switch load-balancing term ``E * sum_e me_e * ce_e`` (mean router
    probability times the top-1 fraction routed), to be weighted by the
    caller. The router runs in fp32; dispatch, the expert products and the
    combine run in ``dtype``.

    Parameters: ``router`` (an fp32 ``Linear(C, E)``, its weight flax's
    kernel transposed) and the stacks ``experts_up [E, C, d_ff]`` and
    ``experts_down [E, d_ff, C]`` in flax's layout, so dim 0 is the expert
    dim that ep (and FSDP's rule) shards. ``ep`` (an :class:`EPContext`,
    set by :meth:`ExpertDataParallel.parallelize`, or by
    ``TensorParallel.parallelize`` when its plan cuts the stacks) switches
    on the expert-parallel forward over the rank's experts; its ``exit``
    may return this rank's T rows of the output (sequence parallelism).
    ``stats_group`` (set by a data-parallel strategy) is the group the aux
    loss's statistics are averaged over.
    """

    ep: Optional[EPContext] = None
    stats_group = None

    def __init__(self, n_experts: int, d_ff: int, n_embd: int, *, k: int = 1,
                 capacity_factor: float = 1.25,
                 group_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n_experts, self.d_ff, self.k = int(n_experts), int(d_ff), int(k)
        self.capacity_factor = float(capacity_factor)
        self.group_size = group_size
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.router = nn.Linear(n_embd, n_experts, **kw)
        self.experts_up = nn.Parameter(torch.empty(n_experts, n_embd, d_ff,
                                                   **kw))
        self.experts_down = nn.Parameter(torch.empty(n_experts, d_ff, n_embd,
                                                     **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: LeCun-normal router kernel, zero bias, and
        the 3-D LeCun-normal expert stacks."""
        w = self.router.weight
        std = w.shape[1] ** -0.5 / _TRUNC_STD
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.router.bias.zero_()
        _lecun_3d(self.experts_up, generator)
        _lecun_3d(self.experts_down, generator)

    def capacity(self, n_tokens: int) -> int:
        """Tokens an expert takes per group (a host number)."""
        gsz = self.group_size or n_tokens
        return max(1, int(self.capacity_factor * gsz * self.k
                          / self.n_experts))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        B, T, C = x.shape
        E, k, dtype = self.n_experts, self.k, self.dtype
        n_tokens = B * T
        gsz = self.group_size or n_tokens
        if n_tokens % gsz:
            raise ValueError(
                f"group_size {gsz} must divide token count {n_tokens}")
        G = n_tokens // gsz
        capacity = self.capacity(n_tokens)

        xg = x.reshape(G, gsz, C)
        r = self.router
        logits = F.linear(xg.float(), r.weight.float(), r.bias.float())
        probs = torch.softmax(logits, dim=-1)                  # [G, n, E]
        gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # [G, n, k]

        w_up, w_dn = self.experts_up, self.experts_down
        xin = xg.to(dtype)
        ep, local = self.ep, None
        if ep is not None:
            e_local = w_up.shape[0]
            local = (ep.rank * e_local, (ep.rank + 1) * e_local)
            xin, gate_vals = ep.enter(xin), ep.enter(gate_vals)
        dispatch, combine = make_dispatch_masks(expert_idx, gate_vals, E,
                                                capacity, dtype, local)
        expert_in = torch.einsum("gnec,gnd->gecd", dispatch, xin)
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, w_up.to(dtype)),
                   approximate="tanh")
        expert_out = torch.einsum("gecf,efd->gecd", h, w_dn.to(dtype))
        if ep is None:
            out = torch.einsum("gnec,gecd->gnd", combine.to(dtype),
                               expert_out).reshape(B, T, C)
        else:
            # the rank's experts' share, summed over ep in fp32
            out = ep.exit(torch.einsum(
                "gnec,gecd->gnd", combine, expert_out.float()
            ).reshape(B, T, C)).to(dtype)

        me = probs.reshape(n_tokens, E).mean(dim=0)
        ce = _one_hot(expert_idx[..., 0].reshape(-1), E).mean(dim=0)
        group = self.stats_group
        if group is not None and dist.get_world_size(group) > 1:
            me, ce = _MeanOver.apply(torch.stack([me, ce]), group,
                                     dist.get_world_size(group)).unbind(0)
        aux_loss = E * (me * ce).sum()
        return out, {"aux_loss": aux_loss, "expert_fraction": ce}


class ExpertParallel(ParallelStyle):
    """Shard an expert stack's leading ``[E]`` dim over the ep axis."""

    def shard_dim(self, name: str, shape) -> Optional[int]:
        return 0 if tuple(shape) else None


class ExpertDataParallel(DataParallel):
    """DDP over ``dp_axis`` with every parameter whose name contains
    ``expert_key`` sharded along its leading ``[E]`` dim over ``ep_axis``.

    The batch splits over ``dp`` only (``DataParallel``'s placement): the
    ep ranks of a dp row see the same rows. :meth:`parallelize` (the
    trainer's ``init`` calls it, after every rank took the first rank's
    whole weights) cuts each expert stack to the rank's ``E/ep`` experts
    (``p.ep``, a ``fsdp.Shard``) and hands the MoE layers their
    :class:`EPContext`. The gradients are averaged over ``dp``: the expert
    stacks' are the rank's experts', and every other one is the same on
    every ep rank (the layer's f/g pair). The global norm adds the expert
    stacks' squares over ep.

    ``param_pspec`` answers the dim a parameter shards along over ep (the
    reference's ``P("ep")`` on an expert stack), on torch shapes.
    """

    expert_parallel = True

    def __init__(self, mesh, dp_axis: str = "dp", ep_axis: str = "ep",
                 expert_key: str = "experts"):
        if ep_axis not in mesh.axis_names:
            raise ValueError(f"axis {ep_axis!r} not in mesh {mesh.axis_names}")
        super().__init__(mesh, dp_axis)
        self.ep_axis = ep_axis
        self.expert_key = expert_key
        # the groups, made in one order on every rank
        self.world_group = mesh.get_group((dp_axis, ep_axis))
        self.ep_group = mesh.get_group(ep_axis)
        self.ep_size = mesh.size(ep_axis)
        self.ep_rank = mesh.get_local_rank(ep_axis)
        self.context = EPContext(self.ep_group, self.ep_size, self.ep_rank)
        self._style = ExpertParallel()

    def param_pspec(self, name: str, shape) -> Optional[int]:
        if self.expert_key in name:
            return self._style.shard_dim(name, shape)
        return None

    @torch.no_grad()
    def sync_params(self, model: torch.nn.Module) -> None:
        """Every rank takes the first rank's whole parameters, before the
        cut (so the ep blocks are blocks of one model), and the MoE layers
        take their aux statistics over dp."""
        if any(hasattr(p, "ep") for p in model.parameters()):
            raise ValueError("sync_params runs before parallelize")
        broadcast_tensors([*model.parameters(), *(
            b for b in model.buffers() if b.is_floating_point())],
            self.world_group)
        for m in model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = self.group

    @torch.no_grad()
    def parallelize(self, model: torch.nn.Module) -> Dict[str, Shard]:
        """Cut every expert stack to this rank's ``E/ep`` experts in place
        (the same ``nn.Parameter``, ``p.ep`` a ``Shard``) and set the MoE
        layers' ``ep``. Returns ``{name: Shard}``."""
        layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
        if not layers:
            raise ValueError("ExpertDataParallel needs a model with MoE "
                             "layers (GPT2Config.moe_experts > 0)")
        cut: Dict[str, Shard] = {}
        for name, p in model.named_parameters():
            dim = self.param_pspec(name, tuple(p.shape))
            if dim is None:
                continue
            if hasattr(p, "ep") or hasattr(p, "fsdp") or hasattr(p, "tp"):
                raise ValueError(f"parameter {name} is sharded already")
            if p.shape[dim] % self.ep_size:
                raise ValueError(f"{name} {tuple(p.shape)}: {p.shape[dim]} "
                                 f"experts do not split over ep "
                                 f"{self.ep_size}")
            spec = Shard(dim, self.ep_group, self.ep_rank, self.ep_size)
            p.data = local_block(p.data, dim, self.ep_rank, self.ep_size)
            p.ep = spec
            cut[name] = spec
        for m in layers:
            m.ep = self.context
        return cut

    @torch.no_grad()
    def grad_norm_and_finite(self, params, grads, finite: torch.Tensor):
        """The global norm of the averaged gradients and the all-finite
        flag: the replicated parameters' squares as they are, the expert
        blocks' summed over ep with the flag (one all-reduce of two
        numbers)."""
        rep = torch.zeros((), dtype=torch.float32, device=finite.device)
        both = torch.zeros(2, dtype=torch.float32, device=finite.device)
        for p, g in zip(params, grads):
            sq = (g.float() * g.float()).sum()
            if hasattr(p, "ep"):
                both[0] += sq
            else:
                rep = rep + sq
        both[1] = (~finite).float()
        comm.all_reduce(both, self.ep_group)
        return torch.sqrt(rep + both[0]), both[1] == 0

    def describe(self) -> str:
        return (f"ExpertDataParallel(dp={self.dp_axis!r}, "
                f"ep={self.ep_axis!r})")
