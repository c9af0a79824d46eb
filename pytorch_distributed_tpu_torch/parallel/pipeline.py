"""Pipeline parallelism: GPipe across ranks, the Trainer's pipelined
GPT-2, and the eager executor with its eight schedules.

Port of ``pytorch_distributed_tpu/parallel/pipeline.py`` (torch
``distributed/pipelining/``: ``PipelineStage``, ``ScheduleGPipe``,
``Schedule1F1B``, the interleaved and zero-bubble families, DualPipeV).

The reference runs GPipe as ONE SPMD program over the ``pp`` mesh axis: a
scan over ticks in which every device computes every tick, the bubble
ticks masked, activations hopping with ``ppermute``, and reverse-mode AD
of the scan giving the backward pipeline. Here a rank is one stage, one
process: :func:`gpipe_spmd` runs the ticks of its own stage only (stage
``s`` works on microbatch ``t - s`` at tick ``t``, so it runs its
microbatches in order and the bubble ticks are simply not run), an
activation goes to stage ``s + 1`` over a point-to-point link
(``parallel.stage_links``), and the backward pipeline is autograd across
ranks: the link that sent an activation receives its gradient in the
backward, and the one that received it sends the gradient back.

* :class:`PipelineParallel` + :class:`GPT2Pipe`: the Trainer's route.
  Stage ``s`` holds GPT-2's blocks ``h.{i}`` for ``i`` in ``[s L/S, (s+1)
  L/S)``, under their global names, and the replicated ``wte``, ``wpe``
  and ``ln_f``; stage 0 runs the embedding, the last stage ``ln_f``, the
  tied head and the loss; the batch splits over ``dp``.
* :class:`EagerPipelineExecutor`: the per-rank action streams of GPipe,
  1F1B, Interleaved-1F1B, LoopedBFS, ZeroBubble-H1, Interleaved-ZB, ZB-V
  and DualPipeV over typed messages, so stages may have any shapes. The
  zero-bubble split of the backward is two ``torch.autograd.grad`` calls
  on the saved graph: B against the stage's input (kept for W with
  ``retain_graph``), W against its parameters.

The schedule classes are the reference's, copied: their action streams
and ``peak_inflight`` are the same for the same arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn
from torch.utils import _pytree as pytree

from pytorch_distributed_tpu_torch.distributed.batch_ops import (
    as_process_group,
)
from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.parallel.stage_links import StageLinks
from pytorch_distributed_tpu_torch.parallel.strategies import (
    _Replicas,
    broadcast_tensors,
)

__all__ = [
    "stack_stage_params",
    "gpipe_spmd",
    "GPT2Pipe",
    "PipelineParallel",
    "EagerPipelineExecutor",
    "ScheduleGPipe",
    "Schedule1F1B",
    "ScheduleDualPipeV",
    "ScheduleInterleaved1F1B",
    "ScheduleInterleavedZeroBubble",
    "ScheduleLoopedBFS",
    "ScheduleZBVZeroBubble",
    "ScheduleZeroBubble",
]

#: gpipe link tags: the forward's under the microbatch, the backward's above
_GPIPE_BWD_TAG = 1 << 20


def stack_stage_params(layer_params_list: Sequence):
    """Stack per-LAYER param pytrees (tensors, or dicts/lists of them)
    along a new leading dim: a stage's slice of the result (its contiguous
    layers, the leading dim kept) is what :func:`gpipe_spmd`'s
    ``stage_fn`` receives."""
    return pytree.tree_map(lambda *xs: torch.stack(xs, dim=0),
                           layer_params_list[0], *layer_params_list[1:])


def _tick_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (SeedSequence)."""
    seed = int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


class _SendAct(torch.autograd.Function):
    """Forward: send ``y`` to the next stage; returns a 0-d zero that ties
    the send into this rank's graph. Backward: receive ``y``'s gradient
    from that stage."""

    @staticmethod
    def forward(ctx, y, links, dst, tag):
        ctx.links, ctx.dst, ctx.tag = links, dst, tag
        ctx.meta = (tuple(y.shape), y.dtype)
        links.send(y, dst, tag)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype = ctx.meta
        dy = ctx.links.recv(shape, dtype, ctx.dst, _GPIPE_BWD_TAG + ctx.tag)
        return dy, None, None, None


class _RecvAct(torch.autograd.Function):
    """Forward: receive the previous stage's activation (``anchor`` is a
    0-d leaf that puts this node into the graph). Backward: send the
    activation's gradient back to that stage."""

    @staticmethod
    def forward(ctx, anchor, links, src, shape, dtype, tag):
        ctx.links, ctx.src, ctx.tag = links, src, tag
        return links.recv(shape, dtype, src, tag)

    @staticmethod
    def backward(ctx, dx):
        ctx.links.send(dx.contiguous(), ctx.src, _GPIPE_BWD_TAG + ctx.tag)
        return None, None, None, None, None, None


def gpipe_spmd(
    stage_fn: Callable,
    mesh,
    *,
    axis: str = "pp",
    dp_axis: Optional[str] = None,
    remat: bool = True,
    with_rng: bool = False,
):
    """Build this rank's GPipe runner.

    Args:
      stage_fn: ``(stage_params, x) -> y`` for ONE stage: this rank's. ``x``
        and ``y`` have the same shape and dtype (the inter-stage contract
        of the reference's stacked form; stages of other shapes are the
        eager executor's).
      mesh: the port's mesh with the ``axis`` pipeline dimension; this
        rank is stage ``mesh.get_local_rank(axis)``.
      axis: pipeline mesh axis name.
      dp_axis: optional data axis: the rank's microbatches are its dp
        shard's rows, and with ``with_rng`` its shard enters the seeds.
      remat: checkpoint each stage application (``torch.utils.checkpoint``,
        non-reentrant): the backward recomputes it.
      with_rng: ``stage_fn`` takes a third argument, a ``torch.Generator``
        for the tick, and ``run`` a third operand ``rng`` (an int). The
        tick's generator is seeded from ``(rng, stage, dp shard,
        microbatch)``, and made again inside a recomputation, so the masks
        differ across stages, shards and microbatches and a recomputation
        draws the same ones.

    Returns ``run(stage_params, microbatches[, rng], draw=None)``:
      * ``stage_params``: what ``stage_fn`` takes (this stage's layers);
      * ``microbatches``: ``[n_micro, micro_batch, ...]``. Only stage 0
        reads its values; the other stages take its shape and dtype (a
        ``meta`` tensor will do);
      * ``draw`` (a runner built without ``with_rng``): ``draw(m)`` is
        called for microbatch ``m`` before its stage application, outside
        the recomputation, and its result is ``stage_fn``'s third
        argument. What a stage draws from a generator that moves on (the
        dropout masks of ``GPT2Pipe``, from a card generator that a CUDA
        graph replay advances) is so drawn once, in microbatch order, and
        the recomputation reuses it;
      * the last stage returns its outputs ``[n_micro, micro_batch, ...]``
        (the reference's ``stacked_out[-1]``). Every other stage returns
        zeros of that shape (its slice of the reference's ``stacked_out``),
        tied to the rank's sends: a backward from any function of them runs
        the stage's part of the backward pipeline (its sends receive their
        gradients from the next stage). So ``run`` is differentiable across
        ranks when every rank takes the backward of the same loss of its
        result.
    """
    n_stages = mesh.size(axis)
    stage = mesh.get_local_rank(axis)
    dp_shard = mesh.get_local_rank(dp_axis) if dp_axis else 0
    device = mesh.device
    last = stage == n_stages - 1
    links = None   # made at the first run that needs them

    def apply(params, x, m, rng, draw):
        args = (params, x)
        if rng is not None:
            def fn(p, h):
                return stage_fn(p, h, _tick_generator(h.device, rng, stage,
                                                      dp_shard, m))
        else:
            fn = stage_fn
            if draw is not None:
                args += (draw(m),)
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def run(stage_params, microbatches, rng=None, draw=None):
        nonlocal links
        if with_rng and rng is None:
            raise ValueError("this runner was built with_rng: pass rng")
        if with_rng and draw is not None:
            raise ValueError("draw is for a runner built without with_rng")
        if links is None and n_stages > 1:
            links = StageLinks(mesh.get_group(axis), device)
        n_micro = microbatches.shape[0]
        shape, dtype = tuple(microbatches.shape[1:]), microbatches.dtype
        grad = torch.is_grad_enabled()
        outs, anchors = [], []
        for m in range(n_micro):   # tick m + stage
            if stage == 0:
                x = microbatches[m]
            elif grad:
                anchor = torch.zeros((), device=device, requires_grad=True)
                x = _RecvAct.apply(anchor, links, stage - 1, shape, dtype, m)
            else:
                x = links.recv(shape, dtype, stage - 1, m)
            y = apply(stage_params, x, m, rng, draw)
            if last:
                outs.append(y)
            elif grad:
                anchors.append(_SendAct.apply(y, links, stage + 1, m))
            else:
                links.send(y, stage + 1, m)
        if last:
            return torch.stack(outs)
        out = torch.zeros((n_micro,) + shape, dtype=dtype, device=device)
        return out + torch.stack(anchors).sum() if anchors else out

    return run


# -- Trainer integration ----------------------------------------------------
class PipelineParallel(_Replicas):
    """The pipelined model's placement: the parameters under
    ``stage_param_keys`` (GPT-2's blocks ``h.{i}``) live on the stage that
    runs them, everything else is replicated on every rank, and the batch
    splits over ``dp_axis`` when given.

    Where the reference cuts dim 0 of its stacked ``[L, ...]`` block tree
    over ``pp``, a port stage holds its layers whole under their global
    names (the model is cut when it is built: :class:`GPT2Pipe`), so
    ``param_pspec`` answers None (no tensor dim is cut) and
    :meth:`is_stage_param` which parameters are the stage's.

    The trainer's step over it:

    * gradients: the replicated leaves' summed over ``pp`` (the tied
      ``wte`` gets its embedding gradient on the first stage and its head
      gradient on the last, ``wpe`` on the first only, ``ln_f`` on the last
      only), then every gradient averaged over ``dp``;
    * the global norm: the stage leaves' squares summed over ``pp`` with
      each replicated leaf counted once, and the all-finite flag reduced
      over ``pp`` too, so clipping and skip-on-inf see the global values;
    * the last stage's loss and metrics are broadcast over ``pp``, so every
      rank reports its dp shard's.
    """

    pipeline_parallel = True

    def __init__(self, mesh, *, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None,
                 stage_param_keys: Sequence[str] = ("h",)):
        if pp_axis not in mesh.axis_names:
            raise ValueError(f"axis {pp_axis!r} not in mesh {mesh.axis_names}")
        super().__init__(mesh, pp_axis, dp_axis)
        self.pp_axis = pp_axis
        self.dp_axis = dp_axis
        self.batch_axes = dp_axis
        #: top-level parameter names of the stage-held layers
        self.stage_param_keys = tuple(stage_param_keys)
        self.n_stages = mesh.size(pp_axis)
        self.stage_index = mesh.get_local_rank(pp_axis)
        # the groups, made in one order on every rank
        self.pp_group = mesh.get_group(pp_axis)
        self.dp_group = mesh.get_group(dp_axis) if dp_axis else None
        self.group = (mesh.get_group((dp_axis, pp_axis)) if dp_axis
                      else self.pp_group)
        self._stage_mask: Optional[List[bool]] = None
        self._metric_keys: Dict[bool, List[str]] = {}

    @property
    def is_last_stage(self) -> bool:
        return self.stage_index == self.n_stages - 1

    @property
    def graph_capturable(self) -> bool:
        """A CUDA graph captures the step's collectives and links on NCCL,
        not on gloo. Only pp 1 has been captured and measured (one card);
        a captured step at pp > 1 issues its blocking sends and receives
        inside the graph, unverified until a run on several cards (ROADMAP
        C)."""
        return dist.get_backend(self.pp_group) == "nccl"

    @property
    def dropout_stream(self) -> Tuple[int, ...]:
        """What, besides the seed and the data shard, chooses the rank's
        dropout stream (``Trainer``): its stage."""
        return (self.stage_index,)

    def is_stage_param(self, name: str) -> bool:
        return name.split(".", 1)[0] in self.stage_param_keys

    def param_pspec(self, name: str, shape) -> Optional[int]:
        return None

    @torch.no_grad()
    def sync_params(self, model: nn.Module) -> None:
        """Every rank takes the first rank's replicated parameters (and
        floating buffers), and every dp replica of a stage its first dp
        rank's stage parameters."""
        named = list(model.named_parameters())
        rep = [p for n, p in named if not self.is_stage_param(n)]
        rep += [b for b in model.buffers() if b.is_floating_point()]
        if rep:
            broadcast_tensors(rep, self.group)
        held = [p for n, p in named if self.is_stage_param(n)]
        if held and self.dp_group is not None:
            broadcast_tensors(held, self.dp_group)

    def parallelize(self, model: nn.Module) -> None:
        """Check that ``model`` is this rank's stage of a pipeline over
        this mesh, and note which gradients are the stage's."""
        stage, n = getattr(model, "stage", None), getattr(model, "n_stages",
                                                          None)
        if (stage, n) != (self.stage_index, self.n_stages):
            raise ValueError(
                f"PipelineParallel needs this rank's stage of a pipelined "
                f"model (GPT2Pipe on the same mesh): stage "
                f"{self.stage_index} of {self.n_stages}, got {stage} of {n}")
        self._stage_mask = [self.is_stage_param(name) for name, p in
                            model.named_parameters() if p.requires_grad]

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The replicated gradients summed over pp and averaged over dp
        (one all-reduce over the (dp, pp) group), the stage's averaged over
        dp (one over the dp group)."""
        mask = self._stage_mask
        dp = self.mesh.size(self.dp_axis) if self.dp_axis else 1
        out = list(grads)
        for held, group in ((False, self.group), (True, self.dp_group)):
            idx = [i for i, m in enumerate(mask) if m == held]
            if not idx or group is None:
                continue
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            comm.all_reduce(flat, group)
            if dp > 1:
                flat /= dp
            for i, new in zip(idx, flat.split([grads[i].numel()
                                               for i in idx])):
                out[i] = new.view_as(grads[i]).to(grads[i].dtype)
        return out

    @torch.no_grad()
    def grad_norm_and_finite(self, params, grads, finite: torch.Tensor):
        """The global norm and all-finite flag: the replicated leaves'
        squares as they are (the same on every stage), the stage leaves'
        summed over pp with the flag (one all-reduce of two numbers)."""
        rep = torch.zeros((), dtype=torch.float32, device=finite.device)
        both = torch.zeros(2, dtype=torch.float32, device=finite.device)
        for held, g in zip(self._stage_mask, grads):
            sq = (g.float() * g.float()).sum()
            if held:
                both[0] += sq
            else:
                rep = rep + sq
        both[1] = (~finite).float()
        comm.all_reduce(both, self.pp_group)
        return torch.sqrt(rep + both[0]), both[1] == 0

    def stage_backward(self, model: nn.Module, batch) -> None:
        """A stage before the last: its part of the pipeline on the batch's
        tokens, and the backward from what it returns, which receives its
        output's gradient from the next stage (``gpipe_spmd``)."""
        model(batch[0], return_hidden=True).sum().backward()

    def stage_forward(self, model: nn.Module, batch) -> None:
        """A stage before the last, in evaluation: its part of the
        pipeline's forward on the batch's tokens."""
        model(batch[0], return_hidden=True)

    def share_metrics(self, loss, metrics, train: bool = True):
        """The last stage's loss and metrics on every rank of the pp group
        (one broadcast of their stack; the metrics' names are broadcast once
        per ``train``, the first time, as host objects)."""
        last = self.n_stages - 1
        if train not in self._metric_keys:
            keys = [sorted(metrics) if self.is_last_stage else None]
            dist.broadcast_object_list(
                keys, src=dist.get_global_rank(self.pp_group, last),
                group=self.pp_group)
            self._metric_keys[train] = keys[0]
        keys = self._metric_keys[train]
        if self.is_last_stage:
            vals = torch.stack([loss.float()]
                               + [metrics[k].float() for k in keys])
        else:
            vals = torch.zeros(1 + len(keys), dtype=torch.float32,
                               device=self.device)
        comm.broadcast(vals, self.pp_group, group_src=last)
        return vals[0], {k: vals[i + 1] for i, k in enumerate(keys)}

    def describe(self) -> str:
        return (f"PipelineParallel(pp={self.pp_axis}, dp={self.dp_axis}, "
                f"mesh={self.mesh!r})")

    def collective_signature(self) -> dict:
        # the stages' activations go point to point (the reference's
        # collective-permute): only all-to-all is foreign to the step
        sig = super().collective_signature()
        sig["forbid"] = ("all-to-all",)
        return sig


def _keep_mask(shape, rate: float, gen: torch.Generator) -> torch.Tensor:
    m = torch.empty(shape, dtype=torch.bool, device=gen.device)
    return m.bernoulli_(1.0 - rate, generator=gen)


class GPT2Pipe(nn.Module):
    """GPT-2 with its block stack pipelined over ``pp``: the stage of this
    rank, a Trainer-ready model.

    ``GPT2Pipe(cfg, mesh, pp_axis="pp", dp_axis=None, n_microbatches=None,
    remat=True, seed=0)`` draws the unsharded model's weights from ``seed``
    (``models.gpt2.GPT2``'s draws, on ``mesh.device``) and keeps the blocks
    of stage ``s = mesh.get_local_rank(pp_axis)``: ``h.{i}`` for ``i`` in
    ``layers = [s L/S, (s+1) L/S)``, under their global names, so its state
    dict carries the unsharded model's keys. ``wte``, ``wpe`` and ``ln_f``
    are replicated on every stage. ``n_microbatches`` defaults to the pp
    size, as in the reference.

    ``forward(tokens [B, T], return_hidden=False)`` (B the rank's rows: its
    dp shard's) splits the batch into ``n_microbatches`` and runs them
    through :func:`gpipe_spmd`. Stage 0 runs the embedding and its dropout;
    the last stage concatenates the microbatches' outputs in order and runs
    ``ln_f`` and the tied head (``GPT2``'s, fp32 logits), and returns the
    logits (or, with ``return_hidden``, the hidden states, for
    ``make_chunked_lm_loss``). Every other stage returns zeros of the
    hidden states' shape, tied to its sends (``gpipe_spmd``): a backward
    from them runs the stage's part of the backward pipeline. ``remat``
    checkpoints each stage application; the config's own block ``remat``
    is not used (the reference applies the blocks without it too).

    Dropout (``cfg.dropout > 0``, in train mode): every mask is drawn from
    ``dropout_generator``, on ``mesh.device`` as ``GPT2``'s is, in one
    order: stage 0 the embedding's, then each microbatch's, block by block
    (attention, then MLP), before the microbatch's stage application
    (``gpipe_spmd``'s ``draw``), so a recomputation reuses them. The
    generator is seeded from ``(seed, stage, dp shard)``; ``Trainer``
    seeds it from its own seed, the data shard and the stage
    (``PipelineParallel.dropout_stream``) and sets it for each step as it
    sets GPT-2's (the card's Philox offset, which a CUDA graph replay
    reads). So the masks differ across stages, data shards, microbatches
    and steps. In eval the same stages run without masks.
    """

    def __init__(self, cfg, mesh, *, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None,
                 n_microbatches: Optional[int] = None,
                 remat: bool = True, seed: int = 0):
        from pytorch_distributed_tpu_torch.models.gpt2 import GPT2

        if getattr(cfg, "moe_experts", 0) > 0:
            raise NotImplementedError(
                "GPT2Pipe stages assume homogeneous dense blocks; MoE "
                "blocks (per-block aux loss, uneven params) are the eager "
                "executor's / ExpertDataParallel's domain")
        n_stages = mesh.size(pp_axis)
        if cfg.n_layer % n_stages:
            raise ValueError(
                f"n_layer {cfg.n_layer} not divisible by pp={n_stages}")
        super().__init__()
        whole = GPT2(cfg, device=mesh.device, seed=seed)
        self.cfg = cfg
        self.mesh = mesh
        self.pp_axis, self.dp_axis = pp_axis, dp_axis
        self.n_stages = n_stages
        self.stage = mesh.get_local_rank(pp_axis)
        self.n_microbatches = n_microbatches or n_stages
        per = cfg.n_layer // n_stages
        self.layers = range(self.stage * per, (self.stage + 1) * per)
        self.wte, self.wpe = whole.wte, whole.wpe
        self.h = nn.ModuleDict({str(i): whole.h[i] for i in self.layers})
        self.ln_f = whole.ln_f
        dp_shard = mesh.get_local_rank(dp_axis) if dp_axis else 0
        self.dropout_generator = (
            _tick_generator(mesh.device, seed, self.stage, dp_shard)
            if cfg.dropout > 0 else None)
        self._runner = gpipe_spmd(self._stage_fn, mesh, axis=pp_axis,
                                  dp_axis=dp_axis, remat=remat)

    @property
    def is_last_stage(self) -> bool:
        return self.stage == self.n_stages - 1

    def blocks(self) -> List[nn.Module]:
        return [self.h[str(i)] for i in self.layers]

    def tied_weight(self) -> torch.Tensor:
        """``wte``, the tied LM head's weight."""
        return self.wte

    def _draw(self, shape):
        """``draw(m)``: microbatch ``m``'s masks, an (attention, MLP) pair a
        block of the stage, from ``dropout_generator``."""
        rate, gen = self.cfg.dropout, self.dropout_generator
        n = len(self.layers)

        def draw(m):
            return [(_keep_mask(shape, rate, gen), _keep_mask(shape, rate, gen))
                    for _ in range(n)]

        return draw

    @staticmethod
    def _stage_fn(blocks, x, drops=None):
        for i, block in enumerate(blocks):
            x = block(x, None if drops is None else drops[i])
        return x

    def forward(self, tokens, *, return_hidden: bool = False):
        from pytorch_distributed_tpu_torch.models.gpt2 import (
            _dropout,
            _layer_norm,
            tied_head,
        )

        cfg = self.cfg
        B, T = tokens.shape
        n = self.n_microbatches
        if B % n:
            raise ValueError(f"batch {B} not divisible by n_microbatches {n}")
        if T > cfg.n_positions:
            raise ValueError(f"sequence length {T} exceeds n_positions "
                             f"{cfg.n_positions}")
        train_dropout = self.dropout_generator is not None and self.training
        shape = (n, B // n, T, cfg.n_embd)
        if self.stage == 0:
            x = (self.wte[tokens.long()].to(cfg.dtype)
                 + self.wpe[:T].to(cfg.dtype))
            if train_dropout:
                keep = _keep_mask(x.shape, cfg.dropout,
                                  self.dropout_generator)
                x = _dropout(x, keep, cfg.dropout)
            mbs = x.reshape(shape)
        else:
            mbs = torch.empty(shape, dtype=cfg.dtype, device="meta")
        stacked = self._runner(
            self.blocks(), mbs,
            draw=self._draw(shape[1:]) if train_dropout else None)
        y = stacked.reshape(B, T, cfg.n_embd)
        if not self.is_last_stage:
            return y
        y = _layer_norm(y, self.ln_f, cfg)
        return y if return_hidden else tied_head(y, self.wte, cfg)


# -- eager executor (torch pipelining parity) -------------------------------
class EagerPipelineExecutor:
    """Per-rank eager pipeline executor over point-to-point stage links.

    Runs a schedule's action stream for this rank: a forward (F) receives
    its stage's input from the previous stage (or takes the microbatch on
    the first virtual stage), runs ``stage_fn`` with autograd recording
    and keeps the graph, and sends the output on; a backward (B) receives
    the output's gradient from the next stage (the last virtual stage seeds
    it with ``1 / n_micro``), takes the gradients of the saved graph and
    sends the input's gradient back, accumulating this stage's parameter
    gradients. The torch analog is ``PipelineStage`` +
    ``Schedule1F1B._step_microbatches`` (``pipelining/schedules.py:995``).

    The zero-bubble schedules split the backward: B is
    ``torch.autograd.grad(out, x, g, retain_graph=True)`` (the input's
    gradient, sent at once; the graph is kept), and W, in its own slot,
    the gradient of the same output against the parameters, accumulated.
    Every link carries a typed message (``stage_links``), so stages may
    have any shapes.

    Args:
      stage_fn: ``(params, x) -> y`` for THIS rank's stage.
      params: this rank's stage parameters (a tensor or a pytree of them;
        leaves that do not require grad are used as detached copies that
        do).
      pg: the process group (the port's, or a c10d one) whose ranks are the
        pipeline stages, in order.
      loss_fn: ``(y, target) -> scalar`` applied by the rank hosting the
        LAST virtual stage: the last rank under Megatron placement; rank 0
        under zbv's V placement (it hosts both stage 0 and stage
        ``2*world-1``, so microbatches AND targets both live there).
      schedule: "gpipe" | "1f1b" | "zb" (ZeroBubble-H1: backward split
        into input-grad B and deferred weight-grad W) | "interleaved" |
        "interleaved_zb" (interleaved skeleton + the B/W split) |
        "looped_bfs" (breadth-first: each chunk runs ALL its microbatches
        before the next) | "zbv" (ZB-V: n_chunks=2 with V placement, chunk
        0 virtual stage ``rank``, chunk 1 ``2*world - 1 - rank``, plus the
        B/W split; same-rank stage links hand off locally) | "dualpipev"
        (torch's DualPipeV stream on the same V placement: paired F/B
        slots issued back-to-back; needs n_microbatches >= 2 * world).
      n_chunks: model chunks per rank (virtual pipeline). With ``n_chunks >
        1`` the schedule must be "interleaved", "interleaved_zb" or
        "looped_bfs" (chunk c of rank r is virtual stage ``c * world +
        r``), or "zbv" / "dualpipev" (V placement above, exactly 2 chunks);
        ``params`` must be a LIST of per-chunk param pytrees and ``run``
        then returns a list of per-chunk grad pytrees.
      async_p2p: sends are posted without waiting, and the nearest upcoming
        receive (within two actions) is posted ahead, so the wire runs
        while the current action computes; False makes every send and
        receive blocking.
    """

    #: tag namespace split: forward activations vs backward grads
    _BWD_TAG = 1 << 20
    #: tag layout: [bwd bit | virtual stage | microbatch]
    _TAG_STRIDE = 1 << 12

    def __init__(self, stage_fn: Callable, params, pg, *,
                 loss_fn: Optional[Callable] = None,
                 schedule: str = "1f1b",
                 n_chunks: int = 1,
                 async_p2p: bool = True):
        self.async_p2p = bool(async_p2p)
        self.stage_fn = stage_fn
        self.chunk_params = list(params) if n_chunks > 1 else [params]
        if len(self.chunk_params) != n_chunks:
            raise ValueError(
                f"need {n_chunks} chunk param trees, got "
                f"{len(self.chunk_params)}")
        self.n_chunks = n_chunks
        if not hasattr(pg, "world_size"):   # a c10d group
            pg = as_process_group(pg)
        self.pg = pg
        self.rank = pg.rank
        self.world = pg.world_size
        self.n_virtual = self.world * n_chunks
        self.schedule = schedule
        #: virtual-stage placement: "megatron" (v = c*world + rank) or "v"
        #: (zbv/dualpipev: rank hosts v=rank AND v=2*world-1-rank)
        self.placement = "v" if schedule in ("zbv", "dualpipev") else "megatron"
        if n_chunks > 1 and schedule not in (
                "interleaved", "interleaved_zb", "looped_bfs", "zbv",
                "dualpipev"):
            raise ValueError(
                "n_chunks > 1 requires schedule='interleaved', "
                "'interleaved_zb', 'looped_bfs', 'zbv', or 'dualpipev'")
        if schedule == "interleaved_zb" and n_chunks < 2:
            raise ValueError("interleaved_zb needs n_chunks >= 2")
        if schedule in ("zbv", "dualpipev") and n_chunks != 2:
            raise ValueError(f"{schedule} requires exactly n_chunks=2")
        self.is_first = self._virtual(0) == 0
        self.is_last = any(self._virtual(c) == self.n_virtual - 1
                           for c in range(n_chunks))
        if self.is_last and loss_fn is None:
            raise ValueError("last stage needs a loss_fn")
        self.loss_fn = loss_fn
        self._leaves, self._specs = [], []
        for p in self.chunk_params:
            leaves, spec = pytree.tree_flatten(p)
            self._leaves.append([t if t.requires_grad
                                 else t.detach().requires_grad_()
                                 for t in leaves])
            self._specs.append(spec)
        self._links = None

    def _virtual(self, chunk: int) -> int:
        if self.placement == "v":
            return self.rank if chunk == 0 else 2 * self.world - 1 - self.rank
        return chunk * self.world + self.rank

    def _rank_of(self, v: int) -> int:
        """Which rank hosts virtual stage ``v``."""
        if self.placement == "v":
            return v if v < self.world else 2 * self.world - 1 - v
        return v % self.world

    def _make_schedule(self, n_micro: int):
        if self.schedule == "interleaved":
            return ScheduleInterleaved1F1B(self.world, n_micro, self.n_chunks)
        if self.schedule == "interleaved_zb":
            return ScheduleInterleavedZeroBubble(self.world, n_micro,
                                                 self.n_chunks)
        if self.schedule == "looped_bfs":
            return ScheduleLoopedBFS(self.world, n_micro, self.n_chunks)
        if self.schedule == "zbv":
            return ScheduleZBVZeroBubble(self.world, n_micro)
        if self.schedule == "dualpipev":
            return ScheduleDualPipeV(self.world, n_micro)
        cls = {"gpipe": ScheduleGPipe, "1f1b": Schedule1F1B,
               "zb": ScheduleZeroBubble}[self.schedule]
        return cls(self.world, n_micro)

    def _fwd_tag(self, recv_virtual: int, m: int) -> int:
        return recv_virtual * self._TAG_STRIDE + m

    def _bwd_tag(self, sender_virtual: int, m: int) -> int:
        return self._BWD_TAG + sender_virtual * self._TAG_STRIDE + m

    def _recv_need(self, act, last_virtual: int) -> Optional[tuple]:
        """(src_rank, tag) this action will pull off the network, or None
        (first/last stage inputs and same-rank handoffs)."""
        v = self._virtual(act.chunk)
        if act.kind == "F" and v != 0:
            src = self._rank_of(v - 1)
            if src != self.rank:
                return (src, self._fwd_tag(v, act.microbatch))
        elif act.kind == "B" and v != last_virtual:
            src = self._rank_of(v + 1)
            if src != self.rank:
                return (src, self._bwd_tag(v + 1, act.microbatch))
        return None

    def _tree(self, c: int, leaves):
        return pytree.tree_unflatten(list(leaves), self._specs[c])

    def run(self, microbatches: Optional[Sequence] = None,
            targets: Optional[Sequence] = None,
            n_microbatches: Optional[int] = None):
        """One full pipeline step.

        Rank 0 passes ``microbatches`` (a list of tensors or arrays); the
        rank of the last virtual stage passes ``targets`` (parallel to
        them); other ranks pass ``n_microbatches``. Returns
        ``(mean_loss_or_None, param_grads)``: the loss (a 0-d tensor) only
        on the rank of the last virtual stage; with ``n_chunks > 1``
        ``param_grads`` is a list of per-chunk grad pytrees.
        """
        # validate per-role inputs BEFORE any P2P starts: a missing input
        # discovered mid-schedule would leave peer ranks blocked in recv
        if self.is_first and microbatches is None:
            raise ValueError("rank 0 (first stage) must pass microbatches")
        if self.is_last and targets is None:
            raise ValueError("last stage must pass targets")
        if microbatches is not None:
            n_micro = len(microbatches)
        elif targets is not None:
            n_micro = len(targets)
        else:
            if n_microbatches is None:
                raise ValueError("intermediate ranks need n_microbatches")
            n_micro = n_microbatches
        if targets is not None and microbatches is not None:
            if len(targets) != len(microbatches):
                raise ValueError("targets and microbatches length mismatch")
        # tag layout safety: an overflowing field would alias two channels
        if n_micro >= self._TAG_STRIDE:
            raise ValueError(f"n_microbatches {n_micro} >= tag stride "
                             f"{self._TAG_STRIDE}")
        if self.n_virtual * self._TAG_STRIDE >= self._BWD_TAG:
            raise ValueError(f"{self.n_virtual} virtual stages overflow the "
                             f"tag namespace")
        sched = self._make_schedule(n_micro)
        split_bw = self.schedule in ("zb", "interleaved_zb", "zbv",
                                     "dualpipev")
        device = self._leaves[0][0].device if self._leaves[0] else (
            torch.device("cpu"))
        if self._links is None:
            self._links = StageLinks(self.pg, device)
        links = self._links
        # same-rank stage links (the V bottom/top) hand off locally
        local_fwd: Dict[tuple, Any] = {}
        local_bwd: Dict[tuple, Any] = {}
        saved: Dict[tuple, tuple] = {}      # (c, m) -> (x, out)
        pending_w: Dict[tuple, Any] = {}    # (c, m) -> output cotangent
        grads = [[torch.zeros_like(t) for t in leaves]
                 for leaves in self._leaves]
        losses = []

        def as_tensor(a):
            return torch.as_tensor(a, device=device)

        def accumulate(c, new):
            for acc, g in zip(grads[c], new):
                if g is not None:
                    acc.add_(g)

        last_virtual = self.n_virtual - 1
        actions = list(sched.actions(self.rank))

        # -- async P2P plumbing ---------------------------------------------
        async_p2p = self.async_p2p
        posted: Dict[tuple, Any] = {}
        send_works: List[Any] = []
        recv_plan = ([self._recv_need(a, last_virtual) for a in actions]
                     if async_p2p else None)

        def post(idx: int) -> None:
            need = recv_plan[idx]
            if need is not None and need not in posted:
                posted[need] = links.irecv_msg(*need)

        def fetch(src_rank: int, tag: int):
            w = posted.pop((src_rank, tag), None) if async_p2p else None
            if w is not None:
                return w.wait()
            return links.recv_msg(src_rank, tag)

        def send(t, dst_rank: int, tag: int) -> None:
            if async_p2p:
                still_going = []
                for w in send_works:
                    if w.is_completed():
                        w.wait()  # re-raise a FAILED send, don't drop it
                    else:
                        still_going.append(w)
                send_works[:] = still_going
                send_works.append(links.isend_msg(t, dst_rank, tag))
            else:
                links.send_msg(t, dst_rank, tag)

        for i, act in enumerate(actions):
            if async_p2p:
                post(i)  # this action's own recv, if any
                # pre-post the next recv only within a short window: a
                # recv's timeout starts when it is posted
                for j in range(i + 1, min(i + 3, len(actions))):
                    if recv_plan[j] is not None:
                        post(j)
                        break
            m, c = act.microbatch, act.chunk
            v = self._virtual(c)
            if act.kind == "F":
                if v == 0:
                    x = as_tensor(microbatches[m])
                else:
                    src_rank = self._rank_of(v - 1)
                    if src_rank == self.rank:
                        x = local_fwd.pop((v, m))
                    else:
                        x = fetch(src_rank, self._fwd_tag(v, m))
                    if x.is_floating_point():
                        x = x.detach().requires_grad_()
                with torch.enable_grad():
                    y = self.stage_fn(self._tree(c, self._leaves[c]), x)
                    out = (self.loss_fn(y, as_tensor(targets[m]))
                           if v == last_virtual else y)
                saved[(c, m)] = (x, out)
                if v == last_virtual:
                    losses.append(out.detach())
                else:
                    dst_rank = self._rank_of(v + 1)
                    if dst_rank == self.rank:
                        local_fwd[(v + 1, m)] = y.detach()
                    else:
                        send(y, dst_rank, self._fwd_tag(v + 1, m))
            elif act.kind == "B":
                if v == last_virtual:
                    # d(mean loss)/d(loss_m)
                    g_out = torch.tensor(1.0 / n_micro, device=device)
                else:
                    src_rank = self._rank_of(v + 1)
                    if src_rank == self.rank:
                        g_out = local_bwd.pop((v + 1, m))
                    else:
                        g_out = fetch(src_rank, self._bwd_tag(v + 1, m))
                x, out = saved[(c, m)]
                g_out = g_out.to(out.dtype)
                takes_dx = x.requires_grad
                if split_bw:
                    # input-grad ONLY (the critical-path half: dx leaves for
                    # the upstream stage now; dW waits for a W slot)
                    dx = (torch.autograd.grad(out, x, g_out,
                                              retain_graph=True)[0]
                          if takes_dx else None)
                    pending_w[(c, m)] = g_out
                else:
                    del saved[(c, m)]
                    inputs = self._leaves[c] + ([x] if takes_dx else [])
                    got = torch.autograd.grad(out, inputs, g_out,
                                              allow_unused=True)
                    accumulate(c, got[:len(self._leaves[c])])
                    dx = got[-1] if takes_dx else None
                if v != 0:
                    dst_rank = self._rank_of(v - 1)
                    if dst_rank == self.rank:
                        local_bwd[(v, m)] = dx
                    else:
                        send(dx, dst_rank, self._bwd_tag(v, m))
            else:  # "W": deferred weight-grad (ZB bubble filler)
                x, out = saved.pop((c, m))
                g = pending_w.pop((c, m))
                accumulate(c, torch.autograd.grad(out, self._leaves[c], g,
                                                  allow_unused=True))

        for w in send_works:  # all wire traffic settled before returning
            w.wait()
        assert not posted, f"unconsumed posted recvs: {list(posted)}"
        assert not saved, f"unconsumed forward residuals: {list(saved)}"
        assert not pending_w, f"unconsumed ZB residuals: {list(pending_w)}"
        assert not local_fwd and not local_bwd, (
            f"unconsumed local handoffs: {list(local_fwd)} / "
            f"{list(local_bwd)}")
        assert not links.pending(), "unconsumed early messages"
        loss = torch.stack(losses).mean() if losses else None
        out_grads = [self._tree(c, g) for c, g in enumerate(grads)]
        return loss, out_grads if self.n_chunks > 1 else out_grads[0]


# -- eager schedule orderings (pipelining/schedules.py parity) --------------
@dataclasses.dataclass(frozen=True)
class _Action:
    kind: str  # "F" | "B" | "W"
    microbatch: int
    chunk: int = 0  # local model chunk (interleaved schedules)

    def __repr__(self):
        c = f".{self.chunk}" if self.chunk else ""
        return f"{self.kind}{self.microbatch}{c}"


class ScheduleGPipe:
    """All forwards, then all backwards (torch ``ScheduleGPipe:872``).
    Peak in-flight activations per stage: n_microbatches."""

    def __init__(self, n_stages: int, n_microbatches: int):
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches

    def actions(self, stage: int) -> List[_Action]:
        fwd = [_Action("F", m) for m in range(self.n_microbatches)]
        bwd = [_Action("B", m) for m in reversed(range(self.n_microbatches))]
        return fwd + bwd

    def peak_inflight(self, stage: int) -> int:
        return self.n_microbatches


class Schedule1F1B:
    """Warmup fwds, then alternate 1 backward / 1 forward, then drain
    (torch ``Schedule1F1B:995``). Peak in-flight activations per stage:
    min(n_stages - stage, n_microbatches) — the memory win over GPipe."""

    def __init__(self, n_stages: int, n_microbatches: int):
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches

    def actions(self, stage: int) -> List[_Action]:
        n, s = self.n_microbatches, self.n_stages
        warmup = min(s - stage, n)
        acts: List[_Action] = [_Action("F", m) for m in range(warmup)]
        next_f, next_b = warmup, 0
        while next_b < n:
            acts.append(_Action("B", next_b))
            next_b += 1
            if next_f < n:
                acts.append(_Action("F", next_f))
                next_f += 1
        return acts

    def peak_inflight(self, stage: int) -> int:
        return min(self.n_stages - stage, self.n_microbatches)


class ScheduleZBVZeroBubble:
    """ZB-V (torch ``ScheduleZBVZeroBubble:3199``; Qi et al.'s V
    schedule): each rank hosts TWO chunks placed in a V — chunk 0 is
    virtual stage ``rank`` (down leg), chunk 1 is ``2*world - 1 - rank``
    (up leg) — so rank 0 holds both the first and the LAST stage and the
    loss is computed where the microbatches enter; combined with the B/W
    backward split this is the zero-bubble V shape.

    Streams are produced by a global tick simulation: one action per rank
    per tick, an action only scheduled when its dependencies completed in
    a STRICTLY earlier tick (cross-rank) — by induction the per-rank
    streams then execute deadlock-free under blocking send/recv.
    Priorities per rank: ready B (critical path, up-leg first), then
    ready F under the residual cap (up-leg first — it unlocks the loss),
    then a deferred W (bubble fill). The residual cap (``2 * world`` live
    F..W windows per rank) gives the ZB-V memory bound.
    """

    def __init__(self, n_stages: int, n_microbatches: int):
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = 2
        self._streams = self._generate()

    def _generate(self) -> List[List[_Action]]:
        p, n = self.n_stages, self.n_microbatches
        V = 2 * p

        def chunk_of(v):
            return 0 if v < p else 1

        done_f: set = set()   # (v, m)
        done_b: set = set()
        streams: List[List[_Action]] = [[] for _ in range(p)]
        pending_w: List[List[Tuple[int, int]]] = [[] for _ in range(p)]
        live = [0] * p        # residuals (F done, W not) per rank
        cap = 2 * p
        next_f = {v: 0 for v in range(V)}   # next microbatch to forward
        next_b = {v: 0 for v in range(V)}
        total = p * (2 * n * 3)  # per rank: 2n each of F, B, W
        emitted = 0
        while emitted < total:
            # done_f/done_b only mutate AFTER the rank loop, so they ARE
            # the strictly-earlier-tick snapshot during it
            prev_f, prev_b = done_f, done_b
            tick_f: List[Tuple[int, int]] = []
            tick_b: List[Tuple[int, int]] = []
            progressed = False
            for r in range(p):
                stages = sorted((r, 2 * p - 1 - r), reverse=True)  # up leg
                act = None
                for v in stages:  # B: critical path
                    m = next_b[v]
                    if m >= n:
                        continue
                    ready = (v, m) in prev_f and (
                        v == V - 1 or (v + 1, m) in prev_b)
                    if ready:
                        act = _Action("B", m, chunk_of(v))
                        tick_b.append((v, m))
                        next_b[v] += 1
                        pending_w[r].append((chunk_of(v), m))
                        break
                if act is None and live[r] < cap:
                    for v in stages:  # F under the memory cap
                        m = next_f[v]
                        if m >= n:
                            continue
                        if v == 0 or (v - 1, m) in prev_f:
                            act = _Action("F", m, chunk_of(v))
                            tick_f.append((v, m))
                            next_f[v] += 1
                            live[r] += 1
                            break
                if act is None and pending_w[r]:
                    c, m = pending_w[r].pop(0)
                    act = _Action("W", m, c)
                    live[r] -= 1
                if act is not None:
                    streams[r].append(act)
                    emitted += 1
                    progressed = True
            done_f.update(tick_f)
            done_b.update(tick_b)
            if not progressed:
                raise RuntimeError(
                    f"zbv schedule generator stalled at {emitted}/{total} "
                    f"(p={p}, n={n})")
        return streams

    def actions(self, stage: int) -> List[_Action]:
        return self._streams[stage]

    def peak_inflight(self, stage: int) -> int:
        return _peak_residuals(self._streams[stage])


def _peak_residuals(actions: List[_Action]) -> int:
    """Peak count of live forward residuals (each lives F → W) for a
    split-backward action stream."""
    live = peak = 0
    for a in actions:
        if a.kind == "F":
            live += 1
            peak = max(peak, live)
        elif a.kind == "W":
            live -= 1
    return peak


class ScheduleZeroBubble:
    """Zero-bubble H1 (the ZB-H1 stream of Qi et al.; torch
    ``ScheduleInterleavedZeroBubble:3007`` family, plain-pipeline
    variant): backward splits into **B** (input-grad — the critical-path
    half, sends dx upstream immediately) and **W** (weight-grad — off the
    critical path). The stream is 1F1B with every drain-phase bubble slot
    filled by a deferred W; remaining W's run after the final B. The
    executor performs the real split with two ``torch.autograd.grad``
    calls (B against the input, W against the parameters).

    Stream shape: steady state runs B, F, W triples (W retires the oldest
    pending weight-grad, so residual residency stays at 1F1B's warmup
    level + 1); the drain phase alternates B, W. F/B ordering is EXACTLY
    1F1B's, so P2P traffic is unchanged.
    """

    def __init__(self, n_stages: int, n_microbatches: int):
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches

    def actions(self, stage: int) -> List[_Action]:
        n, s = self.n_microbatches, self.n_stages
        warmup = min(s - stage, n)
        acts: List[_Action] = [_Action("F", m) for m in range(warmup)]
        next_f = warmup
        pending: List[int] = []
        for m in range(n):
            acts.append(_Action("B", m))
            pending.append(m)
            if next_f < n:
                # steady state: B, F, W — one residual retired per slot
                acts.append(_Action("F", next_f))
                next_f += 1
                acts.append(_Action("W", pending.pop(0)))
            elif m < n - 1:
                # drain bubble slot: weight-grad instead of idling
                acts.append(_Action("W", pending.pop(0)))
        acts.extend(_Action("W", m) for m in pending)
        return acts

    def peak_inflight(self, stage: int) -> int:
        """Peak live residual count (F..W lifetime), by simulation —
        1F1B's min(p - s, n) plus at most one slot of W lag."""
        return _peak_residuals(self.actions(stage))


class ScheduleInterleaved1F1B:
    """Interleaved 1F1B (torch ``ScheduleInterleaved1F1B:2891``, the
    Megatron virtual-pipeline schedule): each rank hosts ``n_chunks`` model
    chunks; virtual stage ``v = chunk * n_stages + rank``. Microbatches run
    in groups of ``n_stages`` per chunk; warmup
    ``(p - rank - 1)*2 + (n_chunks - 1)*p`` forwards, then 1F1B steady
    state, then drain. Shrinks the bubble by ~1/n_chunks vs plain 1F1B.

    Requires ``n_microbatches % n_stages == 0`` (the Megatron constraint).
    """

    def __init__(self, n_stages: int, n_microbatches: int, n_chunks: int):
        if n_microbatches % n_stages:
            raise ValueError(
                f"interleaved schedule needs n_microbatches "
                f"({n_microbatches}) divisible by n_stages ({n_stages})")
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = n_chunks

    def _slot(self, k: int, forward: bool) -> _Action:
        p, vc = self.n_stages, self.n_chunks
        group = p * vc
        chunk = (k % group) // p
        if not forward:
            chunk = vc - 1 - chunk
        m = (k // group) * p + (k % p)
        return _Action("F" if forward else "B", m, chunk)

    def actions(self, stage: int) -> List[_Action]:
        p, vc = self.n_stages, self.n_chunks
        total = self.n_microbatches * vc
        warmup = min(total, (p - stage - 1) * 2 + (vc - 1) * p)
        acts = [self._slot(k, True) for k in range(warmup)]
        for k in range(warmup, total):
            acts.append(self._slot(k, True))
            acts.append(self._slot(k - warmup, False))
        for k in range(total - warmup, total):
            acts.append(self._slot(k, False))
        return acts

    def peak_inflight(self, stage: int) -> int:
        p, vc = self.n_stages, self.n_chunks
        return min(self.n_microbatches * vc,
                   (p - stage - 1) * 2 + (vc - 1) * p + 1)


class ScheduleInterleavedZeroBubble:
    """Interleaved virtual pipeline + zero-bubble backward split (torch
    ``ScheduleInterleavedZeroBubble:3007``): the exact
    :class:`ScheduleInterleaved1F1B` F/B skeleton — so placement, P2P
    traffic, and warmup depth are unchanged — with every backward split
    into B (input-grad, critical path) and W (weight-grad). W placement
    follows the ZB-H1 rule per rank: steady state emits B, F, W triples
    and drain-phase bubbles between consecutive B's run W's; each W
    retires its own B's weight-grad (one slot of residual lag — the H1
    memory bound).
    """

    def __init__(self, n_stages: int, n_microbatches: int, n_chunks: int):
        self._skeleton = ScheduleInterleaved1F1B(n_stages, n_microbatches,
                                                 n_chunks)
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = n_chunks

    def actions(self, stage: int) -> List[_Action]:
        skel = self._skeleton.actions(stage)
        acts: List[_Action] = []
        i = 0
        while i < len(skel):
            a = skel[i]
            acts.append(a)
            if a.kind == "B":
                # steady state emits B, F, W; drain emits B, W — each W
                # retires ITS OWN B's weight-grad
                if i + 1 < len(skel) and skel[i + 1].kind == "F":
                    acts.append(skel[i + 1])
                    i += 1
                acts.append(_Action("W", a.microbatch, a.chunk))
            i += 1
        return acts

    def peak_inflight(self, stage: int) -> int:
        """Peak live residuals (F..W lifetime), by simulation."""
        return _peak_residuals(self.actions(stage))


class ScheduleLoopedBFS:
    """Looped breadth-first pipeline (torch ``ScheduleLoopedBFS:2664``;
    Lamy-Poirier, arXiv:2211.05953): interleaved placement (chunk c of
    rank r is virtual stage ``c * world + r``), but when microbatches are
    ready for multiple local chunks the EARLIER chunk runs all of its
    microbatches first — per rank, all forwards chunk-by-chunk, then all
    backwards in reverse chunk order with reversed microbatch order.
    GPipe-shaped memory (all ``n * n_chunks`` residuals live at the
    turn-around) in exchange for the simplest BFS comm pattern."""

    def __init__(self, n_stages: int, n_microbatches: int, n_chunks: int):
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = n_chunks

    def actions(self, stage: int) -> List[_Action]:
        n = self.n_microbatches
        acts: List[_Action] = []
        for c in range(self.n_chunks):
            acts.extend(_Action("F", m, c) for m in range(n))
        for c in reversed(range(self.n_chunks)):
            acts.extend(_Action("B", m, c) for m in reversed(range(n)))
        return acts

    def peak_inflight(self, stage: int) -> int:
        return self.n_microbatches * self.n_chunks


class ScheduleDualPipeV:
    """DualPipeV (torch ``ScheduleDualPipeV:3393``; the V variant of
    DeepSeek's DualPipe, arXiv:2412.19437): ZB-V's placement — chunk 0 of
    rank r is virtual stage ``r``, chunk 1 is ``2*world - 1 - r`` — with
    torch's exact 8-phase per-rank stream: warmup F0's, F0F1 ramp,
    zero-bubble I1-W1-F1, a steady state of PAIRED F/B slots
    (``OVERLAP_F_B``: one microbatch's forward issued back-to-back with
    another's full backward), B1-F1B0 wind-down, a B1B0 phase that
    switches to the B/W split mid-way (torch's ``enable_zb`` parity
    trick), then W0B0 and trailing W0 drain.

    Torch marks the paired slots ``OVERLAP_F_B`` so its runtime can fuse
    them into one overlapped launch; this executor issues the pair
    back-to-back instead. The pair expands to ``F, B, W`` here because
    torch's pair carries a FULL backward: same math, same wire traffic,
    same slot order.

    Requires ``n_microbatches >= 2 * n_stages`` (torch's bound: at least
    as many microbatches as virtual stages)."""

    def __init__(self, n_stages: int, n_microbatches: int):
        if n_microbatches < 2 * n_stages:
            raise ValueError(
                f"DualPipeV needs n_microbatches >= 2 * n_stages "
                f"({n_microbatches} < {2 * n_stages})")
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = 2
        self._streams = [self._rank_ops(r) for r in range(n_stages)]
        for r, acts in enumerate(self._streams):
            for c in (0, 1):
                for kind in ("F", "B", "W"):
                    got = sum(1 for a in acts
                              if a.kind == kind and a.chunk == c)
                    assert got == n_microbatches, (
                        f"dualpipev rank {r}: chunk {c} has {got} "
                        f"{kind}-actions, want {n_microbatches}")

    def _rank_ops(self, rank: int) -> List[_Action]:
        p, n = self.n_stages, self.n_microbatches
        s0, s1 = rank, 2 * p - 1 - rank  # down-leg / up-leg stages
        chunk_of = {s0: 0, s1: 1}
        counters: Dict[tuple, int] = {}
        weight_queue: List[Tuple[int, int]] = []
        acts: List[_Action] = []

        def add_f(v):
            m = counters.get((v, "F"), 0)
            counters[(v, "F")] = m + 1
            acts.append(_Action("F", m, chunk_of[v]))

        def add_b(v, full: bool):
            m = counters.get((v, "B"), 0)
            counters[(v, "B")] = m + 1
            acts.append(_Action("B", m, chunk_of[v]))
            if full:
                # torch FULL_BACKWARD: weight-grad retired in the same
                # slot, never queued
                acts.append(_Action("W", m, chunk_of[v]))
            else:
                weight_queue.append((v, m))

        def add_w():
            if not weight_queue:
                return
            v, m = weight_queue.pop(0)
            acts.append(_Action("W", m, chunk_of[v]))

        # 1: F0 warmup
        for _ in range((p - rank - 1) * 2):
            add_f(s0)
        # 2: F0F1 ramp
        for _ in range(rank + 1):
            add_f(s0)
            add_f(s1)
        # 3: I1 W1 F1 (zero-bubble on the up leg)
        for _ in range(p - rank - 1):
            add_b(s1, full=False)
            add_w()
            add_f(s1)
        # 4 (main): F0B1 - F1B0 paired slots (torch OVERLAP_F_B)
        for _ in range(n - 2 * p + rank + 1):
            add_f(s0)
            add_b(s1, full=True)
            add_f(s1)
            add_b(s0, full=True)
        # 5: B1 - F1B0 wind-down
        for _ in range(p - rank - 1):
            add_b(s1, full=True)
            add_f(s1)
            add_b(s0, full=True)
        # 6: B1B0, switching to the B/W split mid-way (parity trick)
        enable_zb = False
        k = rank + 1
        for i in range(k):
            if i == k // 2 and rank % 2 == 1:
                enable_zb = True
            add_b(s1, full=not enable_zb)
            if i == k // 2 and rank % 2 == 0:
                enable_zb = True
            add_b(s0, full=not enable_zb)
        # 7: W0 B0
        for _ in range(p - rank - 1):
            add_w()
            add_b(s0, full=not enable_zb)
        # 8: trailing W0 drain
        for _ in range(rank + 1):
            add_w()
        assert not weight_queue, (
            f"dualpipev rank {rank}: {len(weight_queue)} unretired "
            f"weight-grads")
        return acts

    def actions(self, stage: int) -> List[_Action]:
        return self._streams[stage]

    def peak_inflight(self, stage: int) -> int:
        return _peak_residuals(self._streams[stage])
