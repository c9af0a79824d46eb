"""Tensor and sequence parallelism: Megatron's intra-layer sharding.

Port of ``pytorch_distributed_tpu/parallel/tensor_parallel.py`` (torch
``tensor/parallel/style.py``'s ``ColwiseParallel``, ``RowwiseParallel``,
``SequenceParallel``, and ``parallelize_module``). There a style maps a
parameter's flax shape to a ``PartitionSpec`` on the ``tp`` axis, and
GSPMD derives the Megatron collectives from the specs. Here a style names
the **torch** dim that shards (``None``: whole), as ``strategies.py``
does, and :meth:`TensorParallel.parallelize` does the module surgery
that torch's ``parallelize_module`` does:

* a colwise ``Linear`` (``[out, in]``) holds its block of output features
  (torch dim 0) and of its bias; a rowwise ``Linear`` holds its block of
  input features (torch dim 1) and the whole bias, which is added after
  the all-reduce that closes the block. Styles read the logical dim, not
  flax's index: an embedding table (``[rows, features]``: GPT-2's ``wte``
  and ``wpe``) shards its features (torch dim 1) under colwise;
* GPT-2's fused ``c_attn`` (``ColwiseParallel(chunks=3)``) gives each rank
  its ``C/tp`` rows of each of q, k and v, so that a rank holds whole
  heads: the same bytes as the reference's contiguous ``P(None, "tp")``
  block of ``[C, 3C]``, in another element order (ROADMAP C);
* the forward's collectives are ``torch.autograd.Function``s (the
  :class:`TPContext` a parallelized model reads): Megatron's f (identity
  forward, all-reduce backward) where a block's input enters the colwise
  layer and g (all-reduce forward, identity backward) where the rowwise
  output leaves it. With ``sequence_parallel`` the residual stream holds
  ``T/tp`` rows a rank: LayerNorm runs on them, f becomes an all-gather
  along T (reduce-scatter backward) and g a reduce-scatter along T
  (all-gather backward), the pattern the reference's activation constraint
  makes XLA emit. The parameters kept whole on tp then have partial
  gradients (LayerNorm's, the rowwise biases'), which
  :meth:`TensorParallel.reduce_sequence_grads` all-reduces over tp;
  without sequence parallelism they are equal on every tp rank;
* the tied ``wte`` is gathered whole (all-gather of its feature blocks,
  the backward taking the rank's block of the replicated gradient) for the
  embedding lookup and the LM head: 77 MB in bf16 at 125M, where
  all-reducing the ``[B T, V]`` logits would move 1.6 GB in fp32.

``fsdp_axis`` composes FSDP (TP x FSDP): the largest dim that tp leaves
whole shards over ``fsdp`` (the reference's ``_add_fsdp``), the tp block
cut first, then its fsdp block by ``parallel.fsdp`` (whose gather yields
the rank's tp block). The batch splits over ``(dp, fsdp)`` and is
replicated over tp. Every collective goes through ``parallel.comm``.

The reference's ``activation_constraint`` (``GPT2Config.act_constraint``)
has no counterpart: the port's ``GPT2Config`` has no such field, and the
strategy applies sequence parallelism to the model itself.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.parallel.fsdp import gather, reduce_scatter
from pytorch_distributed_tpu_torch.parallel.strategies import (
    _Replicas,
    broadcast_tensors,
)

__all__ = [
    "ParallelStyle",
    "ColwiseParallel",
    "RowwiseParallel",
    "SequenceParallel",
    "Replicated",
    "TensorParallel",
    "TPContext",
    "TPShard",
    "gpt2_tp_plan",
    "tp_block",
    "tp_full_tensor",
]


def _is_table(name: str, shape: Tuple[int, ...]) -> bool:
    """A 2-D tensor that is not a ``Linear``'s ``<module>.weight`` is an
    embedding table ``[rows, features]`` (GPT-2's ``wte`` and ``wpe``)."""
    return len(shape) == 2 and not name.endswith(".weight")


class ParallelStyle:
    """Where one parameter shards over the tp axis: ``shard_dim(name,
    shape)`` is the torch dim (None: whole). ``chunks`` > 1 marks a fused
    projection whose output features are ``chunks`` equal parts, each
    sharded on its own."""

    chunks: int = 1

    def shard_dim(self, name: str, shape: Tuple[int, ...]) -> Optional[int]:
        raise NotImplementedError


class ColwiseParallel(ParallelStyle):
    """Shard the output features (Megatron's column-parallel linear): a
    ``Linear`` weight ``[out, in]`` along dim 0, its bias along dim 0, an
    embedding table ``[rows, features]`` along its features (dim 1).
    ``chunks=3`` is GPT-2's fused q, k, v: a rank holds its block of
    each."""

    def __init__(self, chunks: int = 1):
        self.chunks = int(chunks)

    def shard_dim(self, name, shape):
        if not shape:
            return None
        return len(shape) - 1 if _is_table(name, shape) else 0


class RowwiseParallel(ParallelStyle):
    """Shard the input features (Megatron's row-parallel linear): a
    ``Linear`` weight ``[out, in]`` along dim 1, an embedding table along
    its rows (dim 0); the bias stays whole, added after the all-reduce."""

    def shard_dim(self, name, shape):
        if len(shape) < 2:
            return None
        return 0 if _is_table(name, shape) else 1


class SequenceParallel(ParallelStyle):
    """torch ``SequenceParallel`` shards activations along the sequence
    between the tp regions; its parameters (LayerNorm) stay whole. The
    activation layout is ``TensorParallel(sequence_parallel=True)``'s."""

    def shard_dim(self, name, shape):
        return None


class Replicated(ParallelStyle):
    def shard_dim(self, name, shape):
        return None


@dataclasses.dataclass(frozen=True)
class TPShard:
    """Where a parameter's tp block sits: along ``dim`` of the ``whole``
    torch shape, block ``rank`` of ``size`` over ``group``, of each of
    ``chunks`` equal parts of that dim."""
    dim: int
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    whole: Tuple[int, ...]
    chunks: int = 1


def tp_block(t: torch.Tensor, spec: TPShard) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a contiguous copy)."""
    d, n = spec.dim, spec.chunks
    parts = t.reshape(*t.shape[:d], n, t.shape[d] // n, *t.shape[d + 1:])
    block = parts.chunk(spec.size, d + 1)[spec.rank]
    shape = list(t.shape)
    shape[d] //= spec.size
    return block.reshape(shape).clone(memory_format=torch.contiguous_format)


def tp_full_tensor(t: torch.Tensor, spec: Optional[TPShard]) -> torch.Tensor:
    """The whole tensor from every rank's tp block (collective; a copy of
    ``t`` when ``spec`` is None)."""
    if spec is None:
        return t.detach().clone()
    d, n = spec.dim, spec.chunks
    if n == 1:
        return gather(t.detach(), d, spec.group, spec.size)
    blocks = gather(t.detach(), d, spec.group, spec.size)  # rank-major
    r = blocks.shape[d] // (spec.size * n)
    parts = blocks.reshape(*t.shape[:d], spec.size, n, r, *t.shape[d + 1:])
    # whole on tp: ``spec.whole``, or its fsdp block under TP x FSDP
    return parts.transpose(d, d + 1).reshape(blocks.shape).clone()


# -- the forward's collectives ----------------------------------------------
class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return comm.all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward is ``scatter``'s:
    ``True`` reduce-scatters (the consumers on the ranks differ: SP's f),
    ``False`` takes this rank's block (a replicated consumer: the tied
    tables, the hidden states before the head)."""

    @staticmethod
    def forward(ctx, x, dim, ctx_tp, scatter):
        ctx.dim, ctx.tp, ctx.scatter = dim, ctx_tp, scatter
        return gather(x, dim, ctx_tp.group, ctx_tp.size)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.scatter:
            g = reduce_scatter(g.contiguous(), ctx.dim, tp.group, tp.size)
        else:
            g = g.chunk(tp.size, ctx.dim)[tp.rank].contiguous()
        return g, None, None, None


class _ScatterDim(torch.autograd.Function):
    """Along ``dim``: ``reduce`` True reduce-scatters (SP's g), False
    takes this rank's block (the embeddings entering the sequence-sharded
    stream); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, ctx_tp, reduce):
        ctx.dim, ctx.tp = dim, ctx_tp
        if reduce:
            return reduce_scatter(x.contiguous(), dim, ctx_tp.group,
                                  ctx_tp.size)
        return x.chunk(ctx_tp.size, dim)[ctx_tp.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return gather(g.contiguous(), ctx.dim, tp.group, tp.size), None, \
            None, None


class TPContext:
    """What a parallelized model's forward reads: the tp group, its size
    and this rank's coordinate, and whether the residual stream is
    sequence-sharded. Activations are ``[B, T, C]``."""

    def __init__(self, group, size: int, rank: int,
                 sequence_parallel: bool = False):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.sequence_parallel = bool(sequence_parallel)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A block's input into its colwise layer (Megatron's f; with SP
        the all-gather of the T rows)."""
        if self.sequence_parallel:
            return _GatherDim.apply(x, 1, self, True)
        return _CopyIn.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """A rowwise layer's partial sums out to the residual stream
        (Megatron's g; with SP the reduce-scatter along T)."""
        if self.sequence_parallel:
            return _ScatterDim.apply(x, 1, self, True)
        return _ReduceOut.apply(x, self.group)

    def features(self, w: torch.Tensor) -> torch.Tensor:
        """The whole table from its feature blocks (the gradient: this
        rank's block of the replicated one)."""
        return _GatherDim.apply(w, w.dim() - 1, self, False)

    def split_seq(self, x: torch.Tensor) -> torch.Tensor:
        """SP: this rank's T rows of the (replicated) embeddings."""
        if not self.sequence_parallel:
            return x
        return _ScatterDim.apply(x, 1, self, False)

    def join_seq(self, x: torch.Tensor) -> torch.Tensor:
        """SP: every rank's T rows, for the replicated head."""
        if not self.sequence_parallel:
            return x
        return _GatherDim.apply(x, 1, self, False)


# -- the strategy -----------------------------------------------------------
#: GPT-2's Linear layers that the forward's Megatron pairing needs sharded
_GPT2_PAIRING = (("attn.c_attn", ColwiseParallel),
                 ("attn.c_proj", RowwiseParallel),
                 ("mlp.c_fc", ColwiseParallel),
                 ("mlp.c_proj", RowwiseParallel))


class TensorParallel(_Replicas):
    """TP (optionally x DP or FSDP) driven by a module plan.

    Args:
      mesh: a mesh with ``tp_axis`` (and optionally the dp/fsdp axes).
      plan: ``{regex: ParallelStyle}`` searched in the parameter names
        (``h.0.attn.c_attn.weight``); the first match (insertion order)
        wins; an unmatched parameter stays whole on tp.
      tp_axis / dp_axis / fsdp_axis: mesh axis names.
      min_shard_size: below this many elements a parameter stays whole
        on fsdp.
      sequence_parallel: the residual stream sharded along T over tp.

    Placements (torch shapes, the dim that shards): :meth:`tp_pspec` on
    tp, :meth:`param_pspec` on fsdp (the ``param_axis`` contract of the
    sharded update), :meth:`placement` both. The trainer calls
    :meth:`parallelize` in ``init``.
    """

    tensor_parallel = True

    def __init__(self, mesh, plan: Dict[str, ParallelStyle], *,
                 tp_axis: str = "tp", dp_axis: Optional[str] = "dp",
                 fsdp_axis: Optional[str] = None,
                 min_shard_size: int = 1024,
                 sequence_parallel: bool = False):
        super().__init__(mesh, tp_axis, dp_axis, fsdp_axis)
        self.plan = [(re.compile(pat), style) for pat, style in plan.items()]
        self.tp_axis, self.dp_axis = tp_axis, dp_axis
        self.fsdp_axis = fsdp_axis
        self.min_shard_size = min_shard_size
        self.sequence_parallel = bool(sequence_parallel)
        batch = tuple(a for a in (dp_axis, fsdp_axis) if a is not None)
        self.batch_axes = (batch[0] if len(batch) == 1 else (batch or None))
        self._replica_axes = batch
        # the groups, made in one order on every rank
        self.group = mesh.get_group(batch) if batch else None
        self.tp_group = mesh.get_group(tp_axis)
        self.tp_size = mesh.size(tp_axis)
        self.tp_rank = mesh.get_local_rank(tp_axis)
        if fsdp_axis is not None:
            self.sharded_update = True
            self.param_axis = self.update_axis = fsdp_axis
            self.shard_group = mesh.get_group(fsdp_axis)
            self.shard_replicas = (mesh.get_group(dp_axis)
                                   if dp_axis is not None else None)
        norm_axes = ((fsdp_axis, tp_axis) if fsdp_axis is not None
                     else (tp_axis,))
        self.norm_group = mesh.get_group(norm_axes)
        self.context = TPContext(self.tp_group, self.tp_size, self.tp_rank,
                                 self.sequence_parallel)
        #: per trainable parameter (model order): its gradient is partial
        #: over tp (sequence parallelism; set by ``parallelize``)
        self._partial: List[bool] = []

    # -- placement rules -----------------------------------------------------
    def style_for(self, name: str) -> Optional[ParallelStyle]:
        for pat, style in self.plan:
            if pat.search(name):
                return style
        return None

    def tp_pspec(self, name: str, shape) -> Optional[int]:
        """The torch dim of the whole ``shape`` that shards over tp."""
        style = self.style_for(name)
        return None if style is None else style.shard_dim(name, tuple(shape))

    def param_pspec(self, name: str, shape) -> Optional[int]:
        """The dim of the whole ``shape`` that shards over fsdp (None
        without ``fsdp_axis``): the largest dim tp leaves whole that the
        fsdp size divides (ties to the first), for ``min_shard_size``
        elements or more (the reference's ``_add_fsdp``)."""
        if self.fsdp_axis is None:
            return None
        shape = tuple(shape)
        if not shape or math.prod(shape) < self.min_shard_size:
            return None
        tp_dim = self.tp_pspec(name, shape)
        n = self.mesh.size(self.fsdp_axis)
        best = None
        for i, s in enumerate(shape):
            if i != tp_dim and s % n == 0:
                if best is None or s > shape[best]:
                    best = i
        return best

    def placement(self, name: str, shape) -> Dict[str, int]:
        """``{axis: dim}`` of every axis the parameter shards over."""
        out = {}
        for axis, dim in ((self.tp_axis, self.tp_pspec(name, shape)),
                          (self.fsdp_axis, self.param_pspec(name, shape))):
            if dim is not None:
                out[axis] = dim
        return out

    def held_shape(self, name: str, shape) -> Tuple[int, ...]:
        """The shape of the block a rank holds."""
        held = list(shape)
        for axis, dim in self.placement(name, shape).items():
            held[dim] //= self.mesh.size(axis)
        return tuple(held)

    # -- the model -----------------------------------------------------------
    def _check_gpt2(self, model, cut) -> None:
        blocks = getattr(model, "h", ())
        for i in range(len(blocks)):
            for sub, kind in _GPT2_PAIRING:
                name = f"h.{i}.{sub}.weight"
                style = self.style_for(name)
                if not isinstance(style, kind):
                    raise ValueError(
                        f"{name}: the GPT-2 forward runs Megatron's pairing "
                        f"(c_attn and c_fc colwise, both c_proj rowwise), "
                        f"the plan gives {type(style).__name__}")
                if sub == "attn.c_attn" and style.chunks != 3:
                    raise ValueError(
                        "attn.c_attn is the fused q, k, v: "
                        "ColwiseParallel(chunks=3) gives each rank whole "
                        "heads")
        cfg = model.cfg
        for what, n in (("n_head", cfg.n_head), ("n_embd", cfg.n_embd)):
            if n % self.tp_size:
                raise ValueError(f"{what} {n} does not split over tp "
                                 f"{self.tp_size}")
        if not cut:
            raise ValueError("the plan shards no parameter of the model")

    @torch.no_grad()
    def parallelize(self, model: torch.nn.Module) -> Dict[str, TPShard]:
        """Cut every parameter the plan shards to this rank's tp block, in
        place (the same ``nn.Parameter``, ``p.tp`` a :class:`TPShard`), and
        hand the forward its :class:`TPContext` (every module with a
        ``tp`` attribute: GPT-2's). Returns ``{name: TPShard}``."""
        if not any(hasattr(m, "tp") for m in model.modules()):
            raise NotImplementedError(
                f"{type(model).__name__}'s forward issues no tensor-parallel "
                "collectives: the port's TP runs the GPT-2 model")
        cut: Dict[str, TPShard] = {}
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            dim = self.tp_pspec(name, shape)
            if dim is None:
                continue
            if hasattr(p, "tp") or hasattr(p, "fsdp"):
                raise ValueError(f"parameter {name} is sharded already")
            style = self.style_for(name)
            if shape[dim] % (self.tp_size * style.chunks):
                raise ValueError(f"{name} {shape}: dim {dim} does not split "
                                 f"into {style.chunks} x {self.tp_size}")
            spec = TPShard(dim, self.tp_group, self.tp_rank, self.tp_size,
                           shape, style.chunks)
            p.data = tp_block(p.data, spec)
            p.tp = spec
            cut[name] = spec
        self._check_gpt2(model, cut)
        for m in model.modules():
            if hasattr(m, "tp"):
                m.tp = self.context
        if getattr(model, "_copies", None) is not None:
            model._copies = None    # GPT-2's cached-forward copies: stale
        self._partial = [self.sequence_parallel and not hasattr(p, "tp")
                         and not _is_table(n, tuple(p.shape))
                         for n, p in model.named_parameters()
                         if p.requires_grad]
        return cut

    @torch.no_grad()
    def sync_params(self, model: torch.nn.Module) -> None:
        """Every rank takes the first rank's whole parameters, before the
        cut (so the tp blocks are blocks of one tensor)."""
        if any(hasattr(p, "tp") for p in model.parameters()):
            raise ValueError("sync_params runs before parallelize")
        broadcast_tensors([*model.parameters(), *(
            b for b in model.buffers() if b.is_floating_point())],
            dist.group.WORLD)

    # -- the gradients --------------------------------------------------------
    @torch.no_grad()
    def reduce_sequence_grads(self, grads: List[torch.Tensor]
                              ) -> List[torch.Tensor]:
        """With sequence parallelism: the partial gradients (the
        parameters kept whole on tp) summed over tp, one flat fp32
        all-reduce; the others as they are."""
        idx = [i for i, partial in enumerate(self._partial) if partial]
        if not idx:
            return grads
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        comm.all_reduce(flat, self.tp_group)
        out = list(grads)
        for i, new in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = new.view_as(grads[i]).to(grads[i].dtype)
        return out

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the dp replicas (one flat all-reduce over dp),
        then the sequence-parallel partial sums over tp."""
        if self.group is not None:
            grads = super().reduce_grads(grads)
        return self.reduce_sequence_grads(grads)

    @torch.no_grad()
    def grad_norm_and_finite(self, params, grads: List[torch.Tensor],
                             finite: torch.Tensor):
        """The global norm of the reduced gradients (``grads[i]`` of
        ``params[i]``, a block where the parameter is held as one) and the
        all-finite flag over every rank: each sum of squares weighed by
        the inverse of how many ranks of the ``(fsdp, tp)`` group hold the
        same one, then one all-reduce of two numbers over that group."""
        fsdp = (self.mesh.size(self.fsdp_axis)
                if self.fsdp_axis is not None else 1)
        total = 0
        for p, g in zip(params, grads):
            sq = (g.float() * g.float()).sum()
            copies = ((1 if hasattr(p, "tp") else self.tp_size)
                      * (1 if hasattr(p, "fsdp") else fsdp))
            total = total + (sq if copies == 1 else sq / copies)
        both = torch.stack([torch.as_tensor(total, device=finite.device),
                            (~finite).float()])
        comm.all_reduce(both, self.norm_group)
        return torch.sqrt(both[0]), both[1] == 0

    def collective_signature(self) -> dict:
        """DP's contract plus the tp region's collectives: ``tp`` is
        ``"all_reduce"`` (Megatron's f/g) or, with sequence parallelism,
        ``"reduce_scatter+all_gather"``."""
        sig = super().collective_signature()
        sig["grad_reduce"] = self.group is not None
        sig["param_gather"] = ("per_param" if self.fsdp_axis is not None
                               else "none")
        sig["tp"] = ("reduce_scatter+all_gather" if self.sequence_parallel
                     else "all_reduce")
        return sig


def gpt2_tp_plan() -> Dict[str, ParallelStyle]:
    """The Megatron plan for the port's GPT-2 (the reference's regexes on
    the port's names: ``h.<i>.attn.c_attn`` for ``h_<i>/attn/c_attn``):
    q/k/v and the MLP's up projection colwise (whole heads a rank), the
    attention's and the MLP's output projections rowwise, the embedding
    tables' features colwise, the LayerNorms whole."""
    return {
        r"attn\.c_attn": ColwiseParallel(chunks=3),
        r"attn\.c_proj": RowwiseParallel(),
        r"mlp\.c_fc": ColwiseParallel(),
        r"mlp\.c_proj": RowwiseParallel(),
        r"^wte$|^wpe$": ColwiseParallel(),
        r"ln_|LayerNorm": Replicated(),
    }
