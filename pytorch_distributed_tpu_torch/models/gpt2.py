"""GPT-2 language model in PyTorch: the training and the serving forward.

Port of ``pytorch_distributed_tpu/models/gpt2.py``: learned positional
embeddings, pre-LN blocks, GELU(tanh), causal self-attention, weight-tied
LM head; mixture-of-experts blocks (``moe_experts > 0``), selective
recomputation (``remat_policy``) and dropout. Parameters are kept in
``cfg.param_dtype`` and the compute runs in ``cfg.dtype``, as the flax
model's Dense/LayerNorm ``dtype``/``param_dtype`` split does; LayerNorm
statistics are taken in fp32.

Parameter names mirror the flax paths (``h.<i>.attn.c_attn`` for
``h_<i>/attn/c_attn``), so ``models.convert`` maps one onto the other.

The training forward calls ``cfg.attn_impl`` (``f(q, k, v, causal) ->
out`` over ``[B, T, H, D]``; ``None`` means ``default_attention``), so
``ops.flash_attention`` -- the CUDA causal kernels on the card -- plugs in
without touching the module tree. ``remat=True`` recomputes each block in
the backward (``torch.utils.checkpoint``); ``remat_policy`` names what the
recomputation keeps instead (:data:`REMAT_POLICIES`, the names of
``jax.checkpoint_policies`` that take no argument), as a selective
checkpoint policy over aten ops. The hand-written flash kernels are opaque
to a policy and are recomputed, as a Pallas call is under a dots policy.

With ``moe_experts > 0`` every ``moe_every``-th block (``(i + 1) %
moe_every == 0``) swaps its MLP for ``parallel.expert.MoEMLP``, and the
forward returns ``(logits, moe_aux_weight * sum of the blocks' aux
losses)`` (``(hidden, aux)`` under ``return_hidden``); the cached forward
refuses such a model.

Dropout (``dropout > 0``, in train mode only) sits where the reference's
does: after the embeddings and after each block's attention and MLP output
projections (none on the attention probabilities, none on the MoE output).
It is flax's arithmetic, ``where(keep, x / (1 - rate), 0)`` in ``x``'s
dtype, ``keep`` drawn by ``bernoulli_`` from ``dropout_generator`` (made
from ``seed``; ``Trainer`` sets it a state for each step). A block's masks
are drawn before the block runs and passed in, so a recomputation reuses
them; under sequence parallelism a rank draws the whole mask and keeps its
rows, so the masks are those of the unsharded model.

The cached forward (``kv_cache=...``) updates the cache in place. On the
paged cache, a one-token step (decode) scatters the new K/V through the
block table and runs ``ops.paged_decode_attention`` -- the CUDA kernel on
the card. So does a speculative verify window (``verify=True``): its T
tokens become T rows of the kernel, each attending up to its own position.
A prefill window runs the plain ``paged_cached_attention``; the slotted
cache runs ``cached_attention``. After ``cast_weights()`` (the serving
engine calls it) the cached forward reads compute-dtype copies of the
weights made once, where the training forward casts them on every call
(autograd needs the casts).

``parallel.TensorParallel.parallelize`` cuts the parameters to a rank's
tensor-parallel blocks and sets ``tp`` (a ``TPContext``) on the model and
its blocks; the forward then runs Megatron's collectives: ``H/tp`` local
heads from the rank's rows of each of q, k and v, the block's input
entering through ``tp.enter`` and the rowwise projections' partial sums
leaving through ``tp.exit`` (the bias added after), the tied ``wte`` and
``wpe`` gathered whole (``tp.features``), and under sequence parallelism
the residual stream on ``T/tp`` rows (``tp.split_seq``/``tp.join_seq``).
The cached forward reads whole tables gathered once by
``cast_weights``. An MoE block under tensor parallelism routes the whole
sequence of the rank's rows (``Block._routed``): its expert stacks whole
on every tp rank or cut on the expert dim over tp, as the plan says.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.observability import spans
from pytorch_distributed_tpu_torch.ops.chunked_xent import matmul_f32
from pytorch_distributed_tpu_torch.ops.decode_attention import cached_attention
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    _scatter_new,
    paged_cached_attention,
    paged_decode_attention,
)
from pytorch_distributed_tpu_torch.parallel.expert import MoEMLP

__all__ = ["GPT2Config", "GPT2", "REMAT_POLICIES", "default_attention",
           "gpt2_125m"]

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
#: the supported ``remat_policy`` names: the aten ops whose outputs the
#: recomputation keeps. None keeps what the backward needs, as no
#: recomputation does (the block runs without a checkpoint). A batched
#: ``bmm`` is a dot with batch dims.
REMAT_POLICIES = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "checkpoint_dots_with_no_batch_dims": ("mm", "addmm"),
}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # full per-block activation recomputation in the backward
    remat: bool = False
    # selective recomputation: a name of REMAT_POLICIES (what the
    # recomputation keeps); needs remat=True
    remat_policy: Optional[str] = None
    # mixture of experts: every moe_every-th block swaps its MLP for a
    # top-k routed MoEMLP; the router's aux loss, weighted, is returned
    # beside the logits
    moe_experts: int = 0          # 0 = dense model
    moe_top_k: int = 1
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_group_size: Optional[int] = None
    # pluggable attention: f(q, k, v, causal) -> out, shapes [B, T, H, D]
    attn_impl: Optional[Callable] = None
    # LM-head inputs in fp32 (the default), or in the compute dtype with
    # fp32 accumulation and output
    head_in_fp32: bool = True


def _check_config(cfg: GPT2Config) -> None:
    if cfg.n_embd % cfg.n_head:
        raise ValueError(
            f"n_embd {cfg.n_embd} does not split into {cfg.n_head} heads"
        )
    if cfg.remat_policy is not None and not cfg.remat:
        raise ValueError(
            "remat_policy set but remat=False -- the policy only selects "
            "WHAT the recomputation saves; enable remat=True"
        )
    if cfg.remat_policy is not None and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy {cfg.remat_policy!r} is not supported; the "
            f"policies are {sorted(REMAT_POLICIES)}"
        )


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for a :data:`REMAT_POLICIES` name."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    keep = {getattr(torch.ops.aten, n).default
            for n in REMAT_POLICIES[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        if op in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float
             ) -> torch.Tensor:
    """flax's dropout of ``x`` under the mask ``keep`` (None: off)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


def default_attention(q, k, v, *, causal: bool = True):
    """Reference softmax attention, ``[B, T, H, D]`` layout, fp32 softmax."""
    B, T, H, D = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(D))).to(q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q.device))
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _cast(p: torch.Tensor, dtype: torch.dtype, copies) -> torch.Tensor:
    """``p`` in ``dtype``: its copy in ``copies`` (``GPT2.cast_weights``)
    when given, else a cast made now."""
    return p.to(dtype) if copies is None else copies[p]


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
            copies=None) -> torch.Tensor:
    return F.linear(x.to(dtype), _cast(lin.weight, dtype, copies),
                    _cast(lin.bias, dtype, copies))


def _row_linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
                copies, tp) -> torch.Tensor:
    """A rowwise projection: the partial sums over this rank's input
    features, reduced over tp, plus the whole bias. On one tp rank the
    reduction is the identity and the bias goes into the GEMM, as in the
    unsharded model (so its result is the unsharded one, bit for bit)."""
    if tp is None:
        return _linear(x, lin, dtype, copies)
    w, b = _cast(lin.weight, dtype, copies), _cast(lin.bias, dtype, copies)
    if tp.size == 1:
        return tp.exit(F.linear(x.to(dtype), w, b))
    return tp.exit(F.linear(x.to(dtype), w)) + b


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, cfg: GPT2Config) -> torch.Tensor:
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), cfg.layer_norm_eps)
    return y.to(cfg.dtype)


class SelfAttention(nn.Module):
    tp = None   # the tensor-parallel context (TensorParallel.parallelize)

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x, *, layer_cache=None, position_offset=None,
                copies=None):
        cfg = self.cfg
        B, T, _ = x.shape
        D = cfg.n_embd // cfg.n_head
        # the local heads: a tp rank holds its rows of each of q, k and v
        H = cfg.n_head if self.tp is None else cfg.n_head // self.tp.size
        C = H * D
        q, k, v = _linear(x, self.c_attn, cfg.dtype, copies).split(C, dim=-1)
        q = q.view(B, T, H, D)
        k = k.view(B, T, H, D)
        v = v.view(B, T, H, D)
        if layer_cache is None:
            attn = cfg.attn_impl or default_attention
            y = attn(q, k, v, causal=True)
        elif len(layer_cache) == 4:
            k_pages, v_pages, tables, rows = layer_cache
            if rows is not None:
                pos, row_tables, row_pos = rows
                _scatter_new(k_pages, k, tables, pos)
                _scatter_new(v_pages, v, tables, pos)
                y = paged_decode_attention(
                    q.reshape(B * T, 1, H, D), k_pages, v_pages, row_tables,
                    row_pos).view(B, T, H, D)
            else:
                y, _, _ = paged_cached_attention(
                    q, k, v, k_pages, v_pages, tables, position_offset)
        else:
            y, _, _ = cached_attention(q, k, v, layer_cache[0],
                                       layer_cache[1], position_offset)
        return _row_linear(y.reshape(B, T, C), self.c_proj, cfg.dtype,
                           copies, self.tp)


class MLP(nn.Module):
    tp = None

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **kw)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **kw)

    def forward(self, x, copies=None):
        dtype = self.cfg.dtype
        y = F.gelu(_linear(x, self.c_fc, dtype, copies), approximate="tanh")
        return _row_linear(y, self.c_proj, dtype, copies, self.tp)


class Block(nn.Module):
    """A pre-LN block: attention, then the MLP, or with ``use_moe`` the
    routed ``moe`` (``forward`` then returns ``(x, aux_loss)``). ``drop``
    is the dropout masks of the attention's and the MLP's outputs, or
    None."""

    tp = None

    def __init__(self, cfg: GPT2Config, device=None, use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        kw = dict(eps=cfg.layer_norm_eps, dtype=cfg.param_dtype, device=device)
        self.ln_1 = nn.LayerNorm(cfg.n_embd, **kw)
        self.attn = SelfAttention(cfg, device)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, **kw)
        if use_moe:
            self.moe = MoEMLP(
                cfg.moe_experts, 4 * cfg.n_embd, cfg.n_embd,
                k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                group_size=cfg.moe_group_size, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, device=device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, drop=None, *, layer_cache=None,
                position_offset=None, copies=None):
        cfg = self.cfg
        enter = (lambda h: h) if self.tp is None else self.tp.enter
        attn_keep, mlp_keep = drop or (None, None)
        x = x + _dropout(
            self.attn(enter(_layer_norm(x, self.ln_1, cfg)),
                      layer_cache=layer_cache,
                      position_offset=position_offset, copies=copies),
            attn_keep, cfg.dropout)
        if self.use_moe:
            y, aux = self._routed(_layer_norm(x, self.ln_2, cfg))
            return x + y, aux
        return x + _dropout(self.mlp(enter(_layer_norm(x, self.ln_2, cfg)),
                                     copies), mlp_keep, cfg.dropout)

    def _routed(self, h):
        """The routed MLP and its aux loss. Under tensor parallelism the
        layer routes the whole sequence of the rank's rows, as the
        unsharded model does: without sequence parallelism every tp rank
        holds it already (and the layer's ``ep``, when the plan cut the
        stacks, runs f and g over tp around the rank's experts); with it
        the block gathers T in (``tp.enter``) and keeps its rows of the
        output (its own rows' gradient), or the layer's ``ep``
        reduce-scatters the rank's partial combine, and the aux loss,
        computed whole on every tp rank, counts once."""
        tp = self.tp
        if tp is None or not tp.sequence_parallel:
            y, aux = self.moe(h)
            return y, aux["aux_loss"]
        y, aux = self.moe(tp.enter(h))
        if self.moe.ep is None:
            y = tp.own_rows(y)
        return y, tp.count_once(aux["aux_loss"])


class HeadMatmul(torch.autograd.Function):
    """``logits [N, V] = x [N, C] @ w [V, C]^T`` in fp32 from operands in the
    compute dtype: the reference's ``head_in_fp32=False`` einsum with
    ``preferred_element_type=float32``. ``aten::mm.dtype`` has no autograd
    formula, so the backward is JAX's transpose of that einsum: the fp32
    cotangent g against the widened operands, dx = g w rounded to x's dtype
    and dw = g^T x rounded to w's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        return (torch.mm(g, w.float()).to(x.dtype),
                torch.mm(g.t(), x.float()).to(w.dtype))


def tied_head(x: torch.Tensor, wte: torch.Tensor, cfg: GPT2Config,
              w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight-tied LM head over the whole ``wte`` (the parameter
    dtype): logits in fp32 for a stable softmax, from fp32 operands
    (``head_in_fp32``) or from the compute-dtype ones with fp32 out
    (``HeadMatmul``; ``w`` is ``wte`` in the compute dtype where the
    caller holds it already). The span ``lm_head`` (``observability.spans``)
    bounds it, forward and backward. The weight is cast before the span's
    edge: the edge returns a view of what it is given, through which FSDP's
    ``regather_saved`` still finds the gathered weight."""
    if cfg.head_in_fp32:
        w = wte.float()
    elif w is None:
        w = wte.to(cfg.dtype)
    x, w = spans.enter("lm_head", x, w)
    if cfg.head_in_fp32:
        return spans.leave("lm_head", torch.matmul(x.float(), w.t()))
    logits = HeadMatmul.apply(x.reshape(-1, x.shape[-1]), w)
    return spans.leave("lm_head", logits.reshape(*x.shape[:-1], w.shape[0]))


class GPT2(nn.Module):
    """GPT-2 LM. ``forward(tokens [B, T]) -> logits [B, T, V]`` (fp32).

    ``return_hidden=True`` returns the post-``ln_f`` hidden states
    ``[B, T, C]`` instead of logits: the chunked cross-entropy loss
    (``trainer.make_chunked_lm_loss``) applies the tied ``wte`` head itself,
    so the fp32 ``[B, T, V]`` logits never materialize.

    ``kv_cache`` (a ``serving.KVCache`` or ``serving.paging.PagedKVCache``)
    switches on the serving forward: positions come from
    ``position_offset`` (``[B]`` int32, the current length of each
    sequence), each block attends over its cache instead of the T x T causal
    window, and the call returns ``(logits, kv_cache)`` with the cache
    updated in place. Prefill is this path at T = padded prompt length,
    decode at T = 1. ``verify=True`` marks a speculative verify window
    (the engine's spec step sets it): on a paged cache its T tokens run
    through the decode kernel as T rows, where a prefill window runs the
    plain gather.

    ``n_layers`` (cached path only) truncates the stack to the first N
    blocks, then ``ln_f`` and the tied head: the self-drafting draft of
    speculative decoding. Those blocks compute what the full forward
    computes there, so the draft shares the target's cache and writes only
    the first N layers' K/V.

    ``device=None`` means the CUDA card (and raises without one); weights
    are drawn from a ``torch.Generator`` seeded with ``seed`` on that device,
    and with ``dropout > 0`` the masks from ``dropout_generator`` (seeded
    with ``seed`` on that device too).

    ``cast_weights()`` makes compute-dtype copies of the parameters that
    the cached forward reads from then on (aliases where a parameter is
    already in the compute dtype); call it again after changing the
    parameters, and it refreshes the copies in place.
    """

    tp = None

    def __init__(self, cfg: GPT2Config, *, device=None, seed: int = 0):
        super().__init__()
        _check_config(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd, **kw))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd, **kw))
        self.h = nn.ModuleList(
            Block(cfg, device, cfg.moe_experts > 0
                  and (i + 1) % cfg.moe_every == 0)
            for i in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps, **kw)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        self.dropout_generator = (
            torch.Generator(device=device).manual_seed(seed)
            if cfg.dropout > 0 else None)
        self._copies: Optional[dict] = None
        self._whole: dict = {}

    @torch.no_grad()
    def cast_weights(self) -> None:
        """Make, or refresh in place, the compute-dtype copy of every
        parameter (keyed by the parameter) for the cached forward; each
        copy keeps its storage, and so its ``data_ptr``, across refreshes.
        Under tensor parallelism the copies of ``wte`` and ``wpe`` are the
        whole tables, gathered here (and ``_whole`` keeps them in the
        parameter dtype for the fp32 head)."""
        dtype = self.cfg.dtype
        tables = ({} if self.tp is None else
                  {p: self.tp.features(p.detach())
                   for p in (self.wte, self.wpe)})
        if self._copies is None:
            self._whole = tables
            self._copies = {}
            for p in self.parameters():
                src = tables.get(p, p)
                self._copies[p] = src if src.dtype == dtype else src.to(dtype)
            return
        for p, t in tables.items():
            self._whole[p].copy_(t)
        for p, c in self._copies.items():
            src = self._whole.get(p, p)
            if c is not src:
                c.copy_(src)

    def tied_weight(self) -> torch.Tensor:
        """The whole ``wte`` (the tied LM head's weight; under tensor
        parallelism gathered from its feature blocks)."""
        return self._table("wte")

    def _table(self, name: str, copies=None) -> torch.Tensor:
        """The whole ``wte`` or ``wpe`` in the parameter dtype: gathered
        over tp (the cached forward's, once by ``cast_weights``)."""
        if self.tp is None:
            return getattr(self, name)
        if copies is not None:
            return self._whole[self._parameters[name]]
        return self.tp.features(getattr(self, name))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax model's initializers: normal(0.02) token and normal(0.01)
        position tables, LeCun-normal projections, normal(0.02/sqrt(2L))
        residual outputs, zero biases, unit LayerNorm scales; an MoE
        block's router and expert stacks as ``MoEMLP.reset_parameters``."""
        proj_std = 0.02 / math.sqrt(2 * self.cfg.n_layer)
        self.wte.normal_(0.0, 0.02, generator=generator)
        self.wpe.normal_(0.0, 0.01, generator=generator)
        for block in self.h:
            attn, mlp = block.attn, getattr(block, "mlp", None)
            fan_in = (attn.c_attn,) if mlp is None else (attn.c_attn, mlp.c_fc)
            proj = (attn.c_proj,) if mlp is None else (attn.c_proj, mlp.c_proj)
            for lin in fan_in:
                # truncated at two sigma; 0.8796 restores unit variance
                std = lin.in_features ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            for lin in proj:
                lin.weight.normal_(0.0, proj_std, generator=generator)
            for lin in fan_in + proj:
                lin.bias.zero_()
            if mlp is None:
                block.moe.reset_parameters(generator)
        for ln in [self.ln_f] + [m for b in self.h for m in (b.ln_1, b.ln_2)]:
            ln.weight.fill_(1.0)
            ln.bias.zero_()

    def _head(self, x: torch.Tensor, wte: Optional[torch.Tensor] = None,
              copies=None) -> torch.Tensor:
        if wte is None:
            wte = self._table("wte", copies)
        return tied_head(x, wte, self.cfg,
                         None if copies is None else copies[self.wte])

    def forward(self, tokens, *, return_hidden: bool = False, kv_cache=None,
                position_offset=None, n_layers=None, verify: bool = False):
        if kv_cache is not None:
            return self._cached_forward(tokens, kv_cache, position_offset,
                                        n_layers=n_layers, verify=verify)
        if n_layers is not None:
            raise ValueError(
                "n_layers (truncated draft forward) requires kv_cache"
            )
        cfg = self.cfg
        T = tokens.shape[1]
        if T > cfg.n_positions:
            raise ValueError(
                f"sequence length {T} exceeds n_positions {cfg.n_positions}"
            )
        wte = self._table("wte")
        x = wte[tokens.long()].to(cfg.dtype) + self._table("wpe")[:T].to(
            cfg.dtype)
        keep = self._mask_drawer(x.shape)
        x = _dropout(x, keep(), cfg.dropout)
        if self.tp is not None:
            x = self.tp.split_seq(x)
        # everything_saveable keeps what the backward needs: no checkpoint
        checkpoint = (cfg.remat and torch.is_grad_enabled()
                      and REMAT_POLICIES.get(cfg.remat_policy, ()) is not None)
        remat = {}
        if checkpoint and cfg.remat_policy is not None:
            remat["context_fn"] = _remat_context(cfg.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.h:
            drop = (keep(True), None if block.use_moe else keep(True))
            if checkpoint:
                out = torch.utils.checkpoint.checkpoint(
                    block, x, drop, use_reentrant=False, **remat)
            else:
                out = block(x, drop)
            if block.use_moe:
                x, block_aux = out
                aux = aux + block_aux
            else:
                x = out
        x = _layer_norm(x, self.ln_f, cfg)
        if self.tp is not None:
            x = self.tp.join_seq(x)
        out = x if return_hidden else self._head(x, wte)
        if cfg.moe_experts > 0:
            # the weighted router load-balance loss, consumed by lm_loss
            return out, cfg.moe_aux_weight * aux
        return out

    def _mask_drawer(self, shape):
        """``keep(rows=False)``: the next dropout mask of the whole
        ``[B, T, C]`` activation (None when dropout is off); ``rows`` keeps
        a sequence-parallel rank's T rows of it."""
        g, rate = self.dropout_generator, self.cfg.dropout
        if not (self.training and rate > 0):
            return lambda rows=False: None
        tp = self.tp

        def keep(rows=False):
            m = torch.empty(shape, dtype=torch.bool, device=g.device)
            m.bernoulli_(1.0 - rate, generator=g)
            if rows and tp is not None and tp.sequence_parallel:
                m = m.chunk(tp.size, 1)[tp.rank]
            return m

        return keep

    def _cached_forward(self, tokens, kv_cache, position_offset, *,
                        n_layers=None, verify=False
                        ) -> Tuple[torch.Tensor, object]:
        cfg = self.cfg
        B, T = tokens.shape
        if cfg.moe_experts > 0:
            raise ValueError("kv_cache forward supports dense GPT-2 only "
                             "(moe_experts must be 0)")
        if kv_cache.k.shape[0] != cfg.n_layer:
            raise ValueError(
                f"kv_cache has {kv_cache.k.shape[0]} layers, model has "
                f"{cfg.n_layer}"
            )
        nl = cfg.n_layer if n_layers is None else int(n_layers)
        if not (1 <= nl <= cfg.n_layer):
            raise ValueError(
                f"n_layers {nl} must be in [1, n_layer={cfg.n_layer}]"
            )
        if position_offset is None:
            position_offset = torch.zeros(B, dtype=torch.int32,
                                          device=tokens.device)
        # learned positional embedding at each token's GLOBAL position; the
        # clamp guards the padded tail of an over-long prefill (those query
        # rows are discarded by the engine)
        pos = position_offset.long()[:, None] + torch.arange(
            T, device=tokens.device)
        if self.tp is not None and self.tp.sequence_parallel:
            raise ValueError("the cached forward runs without sequence "
                             "parallelism")
        copies = self._copies
        wte = self._table("wte") if copies is None else copies[self.wte]
        wpe = self._table("wpe") if copies is None else copies[self.wpe]
        x = (wte[tokens.long()].to(cfg.dtype)
             + wpe[pos.clamp(max=cfg.n_positions - 1)].to(cfg.dtype))
        # duck-typed cache dispatch: a paged cache carries block tables
        tables = getattr(kv_cache, "block_tables", None)
        rows = None
        if tables is not None and (T == 1 or verify):
            # each new token is one row of the decode kernel: row (b, t)
            # sits at position offset[b] + t and reads positions <= it
            # through its sequence's table, the causal mask of the window;
            # rows = (write positions [B, T], row tables, row positions)
            if T == 1:
                rows = (pos, tables, position_offset)
            else:
                rows = (pos, tables[:, None].expand(B, T, tables.shape[1])
                        .reshape(B * T, -1), pos.reshape(-1).to(torch.int32))
        for i, block in enumerate(self.h[:nl]):
            layer_cache = (
                (kv_cache.k[i], kv_cache.v[i], tables, rows)
                if tables is not None else (kv_cache.k[i], kv_cache.v[i])
            )
            x = block(x, layer_cache=layer_cache,
                      position_offset=position_offset, copies=copies)
        return self._head(_layer_norm(x, self.ln_f, cfg), copies=copies), \
            kv_cache


def gpt2_125m(*, device=None, seed: int = 0, **overrides) -> GPT2:
    """GPT-2 125M (the reference's config #4 model) with seeded weights."""
    return GPT2(GPT2Config(**overrides), device=device, seed=seed)
