"""Trainer: the training step of the port.

Port of ``pytorch_distributed_tpu/trainer.py`` (``NoShard`` on one
device; ``DataParallel``, ``CPStrategy``, ``ZeRO1``,
``FullyShardedDataParallel``, ``HybridShard``, ``TensorParallel``,
``ExpertDataParallel`` and ``PipelineParallel``, one process per rank).
The JAX step is one jitted program over an immutable state; here the model
holds the parameters and the optimizer its state, and ``step`` updates
both in place. The step keeps the JAX step's order:

  1. the strategy places the batch (its rank's rows under a dp split, in
     the order the microbatches need) and the policy casts its floating
     tensors to the compute dtype;
  2. microbatch accumulation: the grads of ``grad_accum_steps`` equal
     microbatches are summed and divided by their count (the mean); then
     ``strategy.reduce_grads`` averages them over the replicas (the JAX
     step's gradient all-reduce; ``NoShard`` leaves them as they are), or,
     under a strategy with a sharded update (ZeRO1, FSDP),
     ``sharded_update.shard_grads`` puts them into the update layout (the
     reduce-scatter point), so that everything below runs on the shards.
     Microbatch ``i`` is rows ``[i B / accum, (i + 1) B / accum)`` of the
     global batch, as the JAX step's reshape makes it; under a dp split
     each rank holds its share of every microbatch;
  3. with a loss scaler: unscale, and an all-finite check over every grad
     (on the shards: reduced over the shard group on the device, together
     with the norm's sum of squares);
  4. global-norm clipping, ``grads * min(1, clip / (norm + 1e-6))``;
  5. the optimizer step (``torch.optim.AdamW``: the same update as
     ``optax.adamw``; ``torch.optim.SGD`` with momentum and no dampening:
     ``optax.sgd``); under a sharded update it steps on the shards beside
     their state, and ZeRO1 gathers the new values into the whole
     parameters (``sharded_update.apply_sharded_update``);
  6. skip-on-inf: where the step was not finite, the old parameters and
     optimizer state are kept (a device-side ``torch.where``; nothing is
     read back to the host inside the step). The model's buffers (the
     BatchNorm running statistics) keep what the forward wrote, as the
     JAX step keeps the new model state on a skipped step.

With ``comm_hook`` (``DataParallel`` only: replicated parameters, the
batch split over the dp axis) the step takes the reference's manual-DDP
structure: after accumulation the hook replaces the strategy's gradient
reduction (one reduction a step, no_sync semantics), a stateful hook
(``PowerSGD``) carrying its state in ``TrainState.comm_state`` (made by
``init``, updated in place). Each rank's BatchNorm then takes the
statistics of its own rows, unless the model asked for the dp group's
(``bn_axis_name``), as the reference's per-shard step does, and after the
backward the model's floating buffers (the running statistics) are
averaged over the dp group, as the reference ``pmean``s its model state.

Metrics are 0-d tensors on the device: ``loss``, ``grad_norm``,
``all_finite``, the loss function's own (``perplexity`` for the LM losses)
and, with a scaler, ``loss_scale``. ``grad_norm`` is that of the averaged
gradients; ``loss`` and the loss function's metrics are the rank's own
(under a dp split, those of its slice of the batch).

Under a sharded strategy the optimizer is still built by the user over
``model.parameters()``: ``init`` makes the layout
(``sharded_update.ShardedParams``: FSDP holds its parameters as their
shards, in place, so the optimizer keeps pointing at them; ZeRO1 makes a
block of each sharded parameter) and re-points the optimizer's parameter
groups at the tensors it steps on, before its state is created, so the
state is made on the shards. ``trainer.layout`` is that layout (None under
a replicated strategy), and ``models.convert.full_state_dict`` gathers the
shards back into the whole ``state_dict``.

Under ``TensorParallel`` ``init`` cuts the model to the rank's tp blocks
(``strategy.parallelize``: the module surgery, after every rank took the
first rank's whole weights); the gradients are averaged over dp (or, with
``fsdp_axis``, put into the update layout as under FSDP), the
sequence-parallel partial gradients summed over tp, and the norm and
finite flag reduced over the ``(fsdp, tp)`` group
(``strategy.grad_norm_and_finite``). An MoE model's aux loss enters the
loss once, as without TP; under sequence parallelism every tp rank
computes it whole and its gradient counts once (``models.gpt2``).

Under ``ExpertDataParallel`` ``init`` cuts the expert stacks to the
rank's experts (``strategy.parallelize``); the gradients are averaged over
dp, and the norm adds the expert blocks' squares over ep.

Under ``PipelineParallel`` (the model a ``GPT2Pipe`` stage) every rank of
the pp group runs the step: the last stage runs the loss function (the
pipeline's forward, then the head and the loss on the whole batch) and
its scaled loss's backward; every other stage runs its part of the
pipeline and its backward as the strategy says (``stage_backward``). The
gradients
are then reduced by the strategy (the replicated leaves summed over pp,
all averaged over dp), the norm and the finite flag reduced over pp, and
the last stage's loss and metrics broadcast over pp, so every rank reports
its dp shard's. AdamW steps each rank's own leaves: the global update,
since the update is elementwise.

Dropout: the model's ``dropout_generator`` (GPT-2's, with ``dropout >
0``) is set before each step to a state made from the trainer's ``seed``,
the step and the rank's data shard (``strategy.data_shard_index``); the
microbatches and the model's dropout sites draw from it in order. So a
mask is a function of (seed, step, microbatch, data shard, site): a resume
from a checkpoint draws the same masks, two data shards draw different
ones, and the ranks of one data shard (tp, cp, ep) draw the same; a
strategy's ``dropout_stream`` enters the seed too (a pipeline's stage,
whose sites are other layers). On the
card the generator keeps one seed (seed and shard) and its Philox offset
is set from the step, which a CUDA graph replay reads
(``pipeline_exec.AsyncRunner`` registers the generator with its program);
the CPU generator has no offset and is reseeded from all three.

A loss function is ``loss_fn(model, batch, train) -> (loss, metrics)``.

Typical use::

    model = GPT2(cfg, device="cuda")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                            eps=1e-8)
    trainer = Trainer(model, opt, NoShard(), loss_fn=lm_loss, policy="bf16")
    state = trainer.init()
    state, metrics = trainer.step(state, (tokens, targets))
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.amp import GradScaler, Policy, get_policy
from pytorch_distributed_tpu_torch.observability import spans
from pytorch_distributed_tpu_torch.ops.chunked_xent import chunked_cross_entropy
from pytorch_distributed_tpu_torch.parallel import (
    DataParallel,
    ShardingStrategy,
    TrainState,
)
from pytorch_distributed_tpu_torch.parallel.comm_hooks import (
    allreduce_hook,
    get_comm_hook,
)
from pytorch_distributed_tpu_torch.parallel.fsdp import regather_saved
from pytorch_distributed_tpu_torch.parallel.sharded_update import (
    ShardedParams,
    apply_sharded_update,
    grad_norm_and_finite,
    shard_grads,
)

__all__ = [
    "Trainer",
    "classification_loss",
    "lm_loss",
    "lm_loss_chunked",
    "make_chunked_lm_loss",
]


# -- built-in task losses --------------------------------------------------
# signature: loss_fn(model, batch, train) -> (loss, metrics)

def classification_loss(model, batch, train: bool):
    """Softmax cross-entropy on ``(inputs, labels)``. An optional third
    batch element is a per-example validity mask (0/1): padded examples
    contribute nothing, and the mean divides by the real example count."""
    if len(batch) == 3:
        x, y, mask = batch
        mask = mask.float()
    else:
        x, y = batch
        mask = None
    logits = model(x).float()
    per_ex = F.cross_entropy(logits, y.long(), reduction="none")
    hit = (logits.argmax(-1) == y).float()
    if mask is None:
        return per_ex.mean(), {"accuracy": hit.mean()}
    n = torch.clamp(mask.sum(), min=1.0)
    return (per_ex * mask).sum() / n, {"accuracy": (hit * mask).sum() / n}


def _reduce_lm_loss(per_tok, mask, moe_aux, train: bool):
    """Shared tail of the LM losses: mask-aware mean, perplexity, and the
    MoE router's aux term (added to the loss in training only; reported
    as ``moe_aux`` either way). A ``[B]`` mask weighs whole sequences, a
    ``[B, T]`` mask single tokens."""
    if mask is None:
        loss = per_tok.mean()
    else:
        if mask.dim() == 1:
            mask = mask[:, None] * torch.ones_like(per_tok)
        n = torch.clamp(mask.sum(), min=1.0)
        loss = (per_tok * mask).sum() / n
    metrics = {"perplexity": torch.exp(loss)}
    if moe_aux is not None:
        if train:
            loss = loss + moe_aux
        metrics["moe_aux"] = moe_aux
    return loss, metrics


def _lm_batch(batch):
    if len(batch) == 3:
        tokens, targets, mask = batch
        return tokens, targets, mask.float()
    tokens, targets = batch
    return tokens, targets, None


def lm_loss(model, batch, train: bool):
    """Next-token cross-entropy on ``(tokens, targets)`` over fp32 logits.
    Optional third element: per-example or per-token validity mask. An MoE
    model returns ``(logits, weighted router aux loss)``."""
    tokens, targets, mask = _lm_batch(batch)
    out = model(tokens)
    logits, moe_aux = out if isinstance(out, tuple) else (out, None)
    logits = spans.enter("lm_loss", logits).float()
    B, T, V = logits.shape
    per_tok = F.cross_entropy(logits.reshape(B * T, V),
                              targets.reshape(-1).long(),
                              reduction="none").reshape(B, T)
    per_tok = spans.leave("lm_loss", per_tok)
    return _reduce_lm_loss(per_tok, mask, moe_aux, train)


def make_chunked_lm_loss(n_chunks: int = 8) -> Callable:
    """LM loss through :func:`ops.chunked_xent.chunked_cross_entropy`: the
    fp32 ``[B, T, V]`` logits never materialize. The model must support
    ``return_hidden=True`` and tie its head to ``wte``; the head runs on the
    hidden states' dtype with fp32 accumulation."""

    def lm_loss_chunked(model, batch, train: bool):
        tokens, targets, mask = _lm_batch(batch)
        out = model(tokens, return_hidden=True)
        hidden, moe_aux = out if isinstance(out, tuple) else (out, None)
        B, T, C = hidden.shape
        W = model.tied_weight().to(hidden.dtype)
        per_tok = chunked_cross_entropy(
            hidden.reshape(B * T, C), W, targets.reshape(-1), n_chunks
        ).reshape(B, T)
        return _reduce_lm_loss(per_tok, mask, moe_aux, train)

    return lm_loss_chunked


#: default chunked LM loss (8 vocab chunks)
lm_loss_chunked = make_chunked_lm_loss()


def _init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Create Adam/AdamW state now, as ``optax`` ``init`` does, instead of
    at the first step: the skip-on-inf select then has an old state to keep
    on step 1, and converted state can be loaded before any step. Layout as
    torch's own lazy init (``step`` on the CPU unless the group is
    ``capturable`` or ``fused``)."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=p.device if on_device else "cpu")
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
            if group.get("amsgrad"):
                state["max_exp_avg_sq"] = torch.zeros_like(p)


def _init_sgd_state(optimizer: torch.optim.Optimizer) -> None:
    """Create SGD momentum buffers now, as zeros (optax's ``trace`` init):
    torch's first step then gives ``buf = g``, as optax does, and the
    skip-on-inf select has an old buffer to keep on step 1."""
    if not isinstance(optimizer, torch.optim.SGD):
        return
    for group in optimizer.param_groups:
        if not group["momentum"]:
            continue
        for p in group["params"]:
            optimizer.state[p].setdefault("momentum_buffer",
                                          torch.zeros_like(p))


def _microbatches(batch, accum: int) -> List:
    if accum == 1:
        return [batch]
    n = batch[0].shape[0]
    if n % accum:
        raise ValueError(
            f"batch of {n} does not split into {accum} equal microbatches"
        )
    return [tuple(x.reshape(accum, n // accum, *x.shape[1:])[i]
                  for x in batch) for i in range(accum)]


class Trainer:
    """Builds and runs the train/eval step for a placement strategy.

    Args:
      model: ``torch.nn.Module``, its parameters on the strategy's device.
      optimizer: a ``torch.optim`` optimizer over ``model``'s parameters.
      strategy: placement (``NoShard``: the single card; ``DataParallel``
        or ``CPStrategy``: replicas over a mesh axis; ``ZeRO1``,
        ``FullyShardedDataParallel``, ``HybridShard``: sharded;
        ``TensorParallel``: Megatron TP, with DP or FSDP;
        ``ExpertDataParallel``; ``PipelineParallel`` with a ``GPT2Pipe``).
      loss_fn: ``(model, batch, train) -> (loss, metrics)``; see
        ``classification_loss`` / ``lm_loss`` / ``make_chunked_lm_loss``.
      policy: 'fp32' | 'bf16' | 'fp16' | Policy -- batch cast and scaler
        gating. (The model's compute dtype is its own ``dtype``.)
      grad_accum_steps: microbatch count; the batch must divide by it.
      scaler: GradScaler for fp16 (defaults to enabled iff policy is fp16).
      clip_norm: global-norm gradient clipping threshold.
      comm_hook: None, a hook name of ``parallel.comm_hooks`` (``allreduce``,
        ``bf16_compress``, ``fp16_compress``, ``reduce_scatter``,
        ``ring_allreduce``), a callable ``hook(grads, group)``, or a
        stateful hook (``parallel.PowerSGD``); ``DataParallel`` only.
      seed: the dropout masks' seed (the reference's step rng).
    """

    #: the Philox offsets of one step's dropout draws start at
    #: ``step * DROPOUT_OFFSET_STRIDE`` (a multiple of 4, far above what a
    #: step draws)
    DROPOUT_OFFSET_STRIDE = 2 ** 32

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        strategy: ShardingStrategy,
        *,
        loss_fn: Callable = classification_loss,
        policy="fp32",
        grad_accum_steps: int = 1,
        scaler: Optional[GradScaler] = None,
        clip_norm: Optional[float] = None,
        comm_hook=None,
        seed: int = 0,
    ):
        self.comm_hook = comm_hook
        #: a stateful hook (PowerSGD) carries state in TrainState.comm_state
        self.comm_hook_stateful = bool(getattr(comm_hook, "stateful", False))
        self._hook = None
        if comm_hook is not None:
            if (not isinstance(strategy, DataParallel)
                    or getattr(strategy, "update_axis", None) is not None):
                raise ValueError(
                    "Trainer comm_hook supports the DataParallel strategy "
                    "only (replicated params, batch sharded on dp_axis): "
                    "the manual-DDP structure the hook contract assumes")
            self._hook = (comm_hook if self.comm_hook_stateful
                          else get_comm_hook(comm_hook))
        self.model = model
        self.optimizer = optimizer
        self.strategy = strategy
        self.loss_fn = loss_fn
        self.policy: Policy = get_policy(policy)
        self.grad_accum_steps = int(grad_accum_steps)
        if scaler is None and self.policy.needs_loss_scaling:
            scaler = GradScaler()
        self.scaler = scaler
        self.clip_norm = clip_norm
        self._params = [p for p in model.parameters() if p.requires_grad]
        #: the sharded layout (``init`` makes it), or None
        self.layout: Optional[ShardedParams] = None
        self._fsdp = False   # parameters held as shards: regather_saved
        self._tp = bool(getattr(strategy, "tensor_parallel", False))
        self._pp = bool(getattr(strategy, "pipeline_parallel", False))
        # TP, EP and PP cut the model (in ``init``, or PP's when it is
        # built) and reduce the norm themselves
        self._cut = self._tp or self._pp or bool(
            getattr(strategy, "expert_parallel", False))
        self.seed = int(seed)
        #: the generators the model's dropout draws from
        self.generators = [m.dropout_generator for m in model.modules()
                           if getattr(m, "dropout_generator", None)
                           is not None]

    @property
    def _scaling(self) -> bool:
        return self.scaler is not None and self.scaler.enabled

    @property
    def graph_capturable(self) -> bool:
        """Whether the runner may capture the step as a CUDA graph: the
        strategy's collectives can be captured (a pipeline's on NCCL, not
        on gloo)."""
        return bool(getattr(self.strategy, "graph_capturable", True))

    @property
    def _runs_loss(self) -> bool:
        """Whether this rank runs the loss function: every rank but a
        pipeline stage before the last."""
        return not self._pp or self.strategy.is_last_stage

    # -- init --------------------------------------------------------------
    def init(self) -> TrainState:
        """The train state at step 0: every replica takes the first rank's
        parameters, a sharded strategy cuts them (and re-points the
        optimizer at its shards), and the optimizer state is created."""
        dev = self.strategy.device
        for name, p in self.model.named_parameters():
            if p.device != dev:
                raise ValueError(
                    f"parameter {name} is on {p.device}, the strategy places "
                    f"on {dev}"
                )
        if (self._scaling and dev.type == "cuda" and isinstance(
                self.optimizer, (torch.optim.Adam, torch.optim.AdamW))):
            # the skip-on-inf select covers Adam's step count too, so it
            # must live on the card beside the all-finite flag
            for group in self.optimizer.param_groups:
                group["capturable"] = True
        self.strategy.sync_params(self.model)
        if self._cut:
            self.strategy.parallelize(self.model)
        if getattr(self.strategy, "update_axis", None) is not None:
            self.layout = ShardedParams(self.strategy, self.model,
                                        self.optimizer)
            self._fsdp = any(leaf.param_shard is not None
                             for leaf in self.layout.leaves)
        _init_adam_state(self.optimizer)
        _init_sgd_state(self.optimizer)
        comm_state = None
        if self._hook is not None:
            mesh = self.strategy.mesh
            for m in self.model.modules():   # per-rank BN unless asked
                if hasattr(m, "stats_group"):
                    axis = getattr(m, "axis_name", None)
                    m.stats_group = mesh.get_group(axis) if axis else None
            if self.comm_hook_stateful:
                comm_state = self.comm_hook.init(self.model)
        for g in self.generators:
            if g.device.type == "cuda":
                g.manual_seed(self._dropout_seed())
        return TrainState(
            step=0,
            scaler=self.scaler.init(dev) if self.scaler else None,
            comm_state=comm_state,
        )

    def _dropout_seed(self, *more: int) -> int:
        shard = getattr(self.strategy, "data_shard_index", 0)
        stream = getattr(self.strategy, "dropout_stream", ())
        return int(np.random.SeedSequence(
            [self.seed, shard, *stream, *more]).generate_state(
                1, np.uint64)[0])

    def seed_dropout(self, step: int) -> None:
        """Set the dropout generators for step ``step`` (host work, outside
        a graph capture: the card's Philox offset, the CPU's seed)."""
        for g in self.generators:
            if g.device.type == "cuda":
                g.set_offset(step * self.DROPOUT_OFFSET_STRIDE)
            else:
                g.manual_seed(self._dropout_seed(step))

    def program_key(self, step: int):
        """What the step's program depends on besides its tensors: a
        stateful hook's branch at ``step`` (PowerSGD's warm-up or
        compression), else None. The runner captures one program a key."""
        if self.comm_hook_stateful:
            return self.comm_hook.program_key(step)
        return None

    # -- the step ----------------------------------------------------------
    def step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One optimizer step. ``batch`` is a tuple of numpy arrays or
        tensors (placed on the strategy's device)."""
        self.seed_dropout(state.step)
        return self.step_body(state, batch)

    def step_body(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """:meth:`step` without setting the dropout generators: the
        runner's captured body, whose caller sets them before each
        replay."""
        model, params = self.model, self._params
        model.train(True)
        accum = self.grad_accum_steps
        # the span marks (observability.spans; only under the runner's
        # clock) partition the body: forward, backward, grad_exchange,
        # update
        spans.begin("forward")
        batch = self.policy.cast_to_compute(
            self.strategy.place_batch(batch, accum))
        scaling = self._scaling
        for p in params:
            p.grad = None

        layout = self.layout
        losses, per_mb = [], []
        for i, mb in enumerate(_microbatches(batch, accum)):
            if i:
                spans.begin("forward")
            if not self._runs_loss:
                # a stage before the last: the schedule interleaves its
                # forwards and backwards, all counted as backward
                spans.end("forward")
                spans.begin("backward")
                self.strategy.stage_backward(model, mb)
                spans.end("backward")
                continue
            with (regather_saved() if self._fsdp
                  else contextlib.nullcontext()):
                loss, metrics = self.loss_fn(model, mb, True)
            spans.end("forward")
            spans.begin("backward")
            (self.scaler.scale(loss, state.scaler) if scaling
             else loss).backward()
            spans.end("backward")
            losses.append(loss.detach())
            per_mb.append({k: v.detach() for k, v in metrics.items()})
        spans.begin("grad_exchange")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if accum > 1:
            grads = [g / accum for g in grads]
        if layout is not None:
            grads = shard_grads(layout, grads)
            if self._tp:
                grads = self.strategy.reduce_sequence_grads(grads)
        elif self._hook is not None:
            grads, state = self._hooked(state, grads)
        else:
            grads = self.strategy.reduce_grads(grads)
        spans.end("grad_exchange")
        spans.begin("update")
        loss = torch.stack(losses).mean() if losses else None
        metrics = ({k: torch.stack([m[k] for m in per_mb]).mean()
                    for k in per_mb[0]} if per_mb else None)
        if self._pp:
            loss, metrics = self.strategy.share_metrics(loss, metrics)

        if scaling:
            grads, all_finite = self.scaler.unscale(grads, state.scaler)
        else:
            all_finite = torch.ones((), dtype=torch.bool, device=loss.device)
        if self._cut:
            grad_norm, all_finite = self.strategy.grad_norm_and_finite(
                params, grads, all_finite)
        elif layout is not None:
            grad_norm, all_finite = grad_norm_and_finite(layout, grads,
                                                         all_finite)
        else:
            grad_norm = torch.sqrt(sum((g.float() * g.float()).sum()
                                       for g in grads))
        new_scaler = (self.scaler.update(state.scaler, all_finite)
                      if scaling else state.scaler)
        if self.clip_norm is not None:
            factor = torch.clamp(self.clip_norm / (grad_norm + 1e-6), max=1.0)
            grads = [g * factor for g in grads]
        opt_step = ((lambda: self._step_or_keep(all_finite)) if scaling
                    else self.optimizer.step)
        if layout is not None:
            apply_sharded_update(layout, grads, opt_step)
        else:
            for p, g in zip(params, grads):
                p.grad = g.to(p.dtype)
            opt_step()
        spans.end("update")

        out_metrics = {"loss": loss, "grad_norm": grad_norm,
                       "all_finite": all_finite, **metrics}
        if scaling:
            out_metrics["loss_scale"] = state.scaler.scale
        return state.replace(step=state.step + 1, scaler=new_scaler), out_metrics

    @torch.no_grad()
    def _hooked(self, state: TrainState, grads):
        """The hook's mean of the gradients over the dp group (a stateful
        hook's state updated), and the model's floating buffers averaged
        over the group."""
        group = self.strategy.group
        if self.comm_hook_stateful:
            if state.comm_state is None:
                raise ValueError("stateful comm_hook needs comm_state: "
                                 "create the state with Trainer.init()")
            comm_state, grads = self._hook.apply(state.comm_state, grads,
                                                 group, state.step)
            state = state.replace(comm_state=comm_state)
        else:
            grads = self._hook(grads, group)
        buffers = [b for b in self.model.buffers() if b.is_floating_point()]
        if buffers:
            for b, new in zip(buffers, allreduce_hook(buffers, group)):
                b.copy_(new)
        return grads, state

    @torch.no_grad()
    def _step_or_keep(self, all_finite: torch.Tensor) -> None:
        """Optimizer step, then keep the old params (the shards under a
        sharded update) and optimizer state wherever ``all_finite`` is
        False."""
        opt = self.optimizer
        tensors = (self._params if self.layout is None
                   else self.layout.tensors)
        old_params = [p.detach().clone() for p in tensors]
        old_state = {p: {k: v.clone() for k, v in opt.state[p].items()
                         if isinstance(v, torch.Tensor)}
                     for p in tensors}
        opt.step()
        for p, old in zip(tensors, old_params):
            p.copy_(torch.where(all_finite, p, old))
        for p, saved in old_state.items():
            st = opt.state[p]
            for k, old in saved.items():
                st[k].copy_(torch.where(all_finite.to(old.device), st[k], old))

    def run(self, state: TrainState, batches, *, depth: int = 2,
            drain_every: int = 32):
        """Drive a whole batch stream through the pipelined executor
        (:class:`..pipeline_exec.AsyncRunner`): one CUDA graph replay per
        step on the card, up to ``depth`` steps in flight, metrics kept in
        an on-device ring copied to the host every ``drain_every`` steps
        without blocking; the host blocks only at the end. Returns
        ``(final_state, MetricHistory)``: the per-step metric series that
        sequential :meth:`step` calls would return."""
        from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

        runner = AsyncRunner(self, depth=depth, drain_every=drain_every)
        return runner.run(state, batches)

    def step_artifacts(self, state: TrainState, batch):
        """``(program, inventory)`` of the train step on batches shaped as
        ``batch``: the step's ``_graphs.Program`` as the runner builds it
        (one CUDA graph on the card, the eager body on the CPU) and the
        collectives recorded when it was built (``parallel.comm.Call`` records,
        the IR audit's inventory). The reference's ``step_artifacts``
        (lowered and compiled HLO). Runs no step on ``state``: the build's
        warm-up steps are undone, every state tensor keeps its values and
        its address."""
        from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

        runner = AsyncRunner(self, depth=1, drain_every=1)
        runner.start(state, batch)
        return runner.step_artifacts(batch)

    # -- eval --------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict:
        self.model.train(False)
        try:
            batch = self.policy.cast_to_compute(
                self.strategy.place_batch(batch))
            if self._runs_loss:
                loss, metrics = self.loss_fn(self.model, batch, False)
            else:
                loss, metrics = None, None
                self.strategy.stage_forward(self.model, batch)
            if self._pp:
                loss, metrics = self.strategy.share_metrics(loss, metrics,
                                                            train=False)
        finally:
            self.model.train(True)
        return {"loss": loss, **metrics}
