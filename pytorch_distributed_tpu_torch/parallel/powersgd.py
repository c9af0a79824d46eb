"""PowerSGD gradient compression: a low-rank all-reduce with error
feedback (torch ``ddp_comm_hooks/powerSGD_hook.py``; Vogels et al.,
NeurIPS 2019).

Port of ``pytorch_distributed_tpu/parallel/powersgd.py``. Per compressible
gradient ``M [n, m]`` (two dims or more, reshaped ``[shape[0], -1]``):

  1. error feedback: ``M += e`` (``e`` is this rank's residual);
  2. ``P = M Q``; all-reduce P (sum); orthogonalize P: torch's own dispatch,
     QR for several fp32 columns, Gram-Schmidt (epsilon added to the norm)
     for one column or a nonzero epsilon;
  3. ``Q = M^T P``; mean all-reduce Q;
  4. ``M_hat = P Q^T``; ``e = M - M_hat``; the output is ``M_hat``.

On the wire a compressed tensor costs ``(n + m) * rank`` elements where
the dense one costs ``n * m``; a tensor where that is not a gain of
``min_compression_rate`` (torch ``_should_compress``), and every 1-D
tensor, takes the plain mean.

**The reference's layout.** The JAX package compresses each gradient in
its flax layout: a Dense kernel ``[in, out]``, a conv kernel HWIO. A torch
``Linear`` weight is ``[out, in]`` and a conv weight OIHW, and
``reshape(shape[0], -1)`` of those is another matrix (for ResNet-50's
convs a far smaller one to compress). So :meth:`PowerSGD.init` reads the
model and sees each ``Linear`` weight transposed and each 4-D weight
permuted OIHW -> HWIO (the rule of ``models/convert.py``), and compresses
``permute(grad)``; the plan, the factors, the error buffers and
:meth:`~PowerSGD.wire_elements` are the reference's.

**State.** ``comm_state`` is ``{str(leaf): {"q": [m, r], "e": [n, m]}}``,
fp32 on the gradients' device: Q identical on every rank (seeded, then
mean all-reduced each step) and warm-started across steps; ``e`` this
rank's own residual (the reference holds ``[dp, n, m]`` sharded over dp:
each device its own slice). :meth:`apply` updates both in place, so a
captured step replays on the same tensors. Q is drawn from a
``torch.Generator`` seeded from (seed, leaf, step), not ``jax.random``'s
draws: to compare with the reference, carry its Q across.

**Warm-up.** The first ``start_iter`` steps are the plain mean and leave
the state as it is (torch's ``start_powerSGD_iter``); the reference
branches with ``lax.cond`` on its step count, the port on the Python step
count, so a captured step is one of two programs (``program_key``).

The collectives are batched as torch's hook batches them: every P in one
all-reduce, every Q in one, the uncompressed gradients in one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from pytorch_distributed_tpu_torch.parallel import comm
from pytorch_distributed_tpu_torch.parallel.comm_hooks import allreduce_hook

__all__ = ["PowerSGD", "reference_layout"]

#: the permutation that takes a torch weight to the reference's layout
_LINEAR = (1, 0)          # [out, in] -> [in, out]
_CONV = (2, 3, 1, 0)      # OIHW -> HWIO


def reference_layout(model: nn.Module) -> List[Optional[Tuple[int, ...]]]:
    """Per trainable parameter of ``model`` (``model.parameters()`` order),
    the permutation of its dims into the JAX package's layout, or None
    where the layouts agree: a ``Linear`` weight is transposed, a 4-D
    (conv) weight permuted OIHW -> HWIO, as ``models/convert.py`` maps
    flax kernels onto torch weights."""
    perm = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if p.dim() == 4:
                perm[id(p)] = _CONV
            elif isinstance(module, nn.Linear) and name == "weight":
                perm[id(p)] = _LINEAR
    return [perm.get(id(p)) for p in model.parameters() if p.requires_grad]


def _permuted(shape, perm) -> Tuple[int, ...]:
    return tuple(shape[d] for d in perm) if perm else tuple(shape)


@dataclasses.dataclass(frozen=True)
class _LeafPlan:
    compress: bool
    n: int = 0
    m: int = 0


def _orthogonalize_gram_schmidt(p: torch.Tensor, epsilon: float):
    """Column-wise Gram-Schmidt, as torch's ``_orthogonalize_gram_schmidt``
    (epsilon added to each column's norm)."""
    cols = []
    for i in range(p.shape[1]):
        col = p[:, i]
        for prev in cols:
            col = col - torch.sum(prev * col) * prev
        cols.append(col / (torch.linalg.vector_norm(col) + epsilon))
    return torch.stack(cols, dim=1)


def _orthogonalize(p: torch.Tensor, epsilon: float, method: str = "auto"):
    """torch's ``_orthogonalize`` dispatch: QR for several fp32 columns,
    Gram-Schmidt for one column or a nonzero epsilon. QR's column signs may
    differ from Gram-Schmidt's; they cancel in ``P (M^T P)^T``, and every
    rank orthogonalizes the same all-reduced P."""
    if method == "auto":
        method = "gs" if (p.shape[1] == 1 or epsilon != 0.0) else "qr"
    if method == "qr":
        return torch.linalg.qr(p).Q
    return _orthogonalize_gram_schmidt(p, epsilon)


class PowerSGD:
    """Stateful ``Trainer`` comm hook (``Trainer(comm_hook=PowerSGD(...))``).

    The arguments are torch ``PowerSGDState``'s: ``rank`` (r),
    ``start_iter`` (plain-mean warm-up steps), ``min_compression_rate``,
    ``use_error_feedback``, ``warm_start`` (keep Q across steps), ``seed``
    (Q's draws), ``orthogonalization_epsilon``, ``orthogonalization``
    (``"auto"``, torch's dispatch, or ``"qr"`` / ``"gs"``).
    """

    stateful = True
    #: the comm_state keys each rank holds its own of (the checkpoint saves
    #: them as blocks over dp; Q is the same on every rank)
    per_rank_keys = ("e",)

    def __init__(self, rank: int = 2, *, start_iter: int = 10,
                 min_compression_rate: float = 2.0,
                 use_error_feedback: bool = True, warm_start: bool = True,
                 seed: int = 0, orthogonalization_epsilon: float = 0.0,
                 orthogonalization: str = "auto"):
        self.rank = int(rank)
        self.start_iter = int(start_iter)
        self.min_compression_rate = float(min_compression_rate)
        self.use_error_feedback = bool(use_error_feedback)
        self.warm_start = bool(warm_start)
        self.seed = int(seed)
        self.eps = float(orthogonalization_epsilon)
        if orthogonalization not in ("auto", "qr", "gs"):
            raise ValueError(
                "orthogonalization must be 'auto', 'qr', or 'gs'")
        self.orthogonalization = orthogonalization
        #: per gradient, the permutation into the reference's layout
        #: (``init`` reads it from the model; None: as given)
        self.layout: Optional[List] = None

    # -- planning ----------------------------------------------------------
    def _plan(self, shape: Sequence[int]) -> _LeafPlan:
        """The reference's plan for a gradient of ``shape`` (its layout)."""
        if len(shape) < 2:
            return _LeafPlan(False)
        n, m = shape[0], 1
        for s in shape[1:]:
            m *= s
        r = min(self.rank, n, m)
        # torch _should_compress: compressed * rate < uncompressed
        if (n + m) * r * self.min_compression_rate < n * m:
            return _LeafPlan(True, n, m)
        return _LeafPlan(False)

    def _perm(self, i: int):
        return self.layout[i] if self.layout is not None else None

    def _shapes(self, shapes_or_model) -> List[Tuple[int, ...]]:
        """Shapes in the reference's layout: a model's parameters permuted
        by :func:`reference_layout`, or shapes taken as given."""
        if isinstance(shapes_or_model, nn.Module):
            params = [p for p in shapes_or_model.parameters()
                      if p.requires_grad]
            return [_permuted(p.shape, perm) for p, perm in
                    zip(params, reference_layout(shapes_or_model))]
        return [tuple(getattr(s, "shape", s)) for s in shapes_or_model]

    # -- state -------------------------------------------------------------
    def init(self, model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
        """Bind the hook to ``model``'s layout and make its comm state (Q
        and the error buffer of each compressible gradient, fp32 on the
        parameter's device)."""
        params = [p for p in model.parameters() if p.requires_grad]
        self.layout = reference_layout(model)
        state = {}
        for i, (p, shape) in enumerate(zip(params, self._shapes(model))):
            plan = self._plan(shape)
            if not plan.compress:
                continue
            entry = {}
            if self.warm_start:
                entry["q"] = self._fresh_q(i, 0, plan, p.device)
            if self.use_error_feedback:
                entry["e"] = torch.zeros(plan.n, plan.m, dtype=torch.float32,
                                         device=p.device)
            state[str(i)] = entry
        return state

    def _fresh_q(self, leaf: int, step: int, plan: _LeafPlan,
                 device) -> torch.Tensor:
        """The rank-agreed random projection of ``leaf`` at ``step`` (a
        redraw every step without ``warm_start``, as torch's seeded
        generator gives)."""
        r = min(self.rank, plan.n, plan.m)
        seed = ((self.seed * 1_000_003 + leaf) * 1_000_003 + step) % 2**63
        g = torch.Generator().manual_seed(seed)
        return torch.randn(plan.m, r, generator=g).to(device)

    def program_key(self, step: int) -> bool:
        """Which of the two step programs runs at ``step``: the compressed
        one (True) or the warm-up's plain mean."""
        return step >= self.start_iter

    # -- the hook ----------------------------------------------------------
    @torch.no_grad()
    def apply(self, comm_state, grads: Sequence[torch.Tensor], group,
              step: int):
        """``(comm_state, synced)``: the state updated in place, and the
        mean over ``group`` of each gradient (decompressed where
        compressed)."""
        if not self.program_key(step):
            return comm_state, allreduce_hook(grads, group)
        n_ranks = dist.get_world_size(group)
        out: List = [None] * len(grads)
        dense, work = [], []
        for i, g in enumerate(grads):
            key = str(i)
            perm = self._perm(i)
            plan = self._plan(_permuted(g.shape, perm))
            if not plan.compress or key not in comm_state:
                dense.append(i)
                continue
            gm = (g.permute(perm) if perm else g).reshape(plan.n, plan.m)
            gm = gm.float()
            entry = comm_state[key]
            if self.use_error_feedback:
                gm = gm + entry["e"]
            q = (entry["q"] if self.warm_start
                 else self._fresh_q(i, step, plan, g.device))
            work.append((i, gm, q, entry, perm))
        if dense:
            for i, new in zip(dense, allreduce_hook([grads[i] for i in dense],
                                                    group)):
                out[i] = new
        if not work:
            return comm_state, out
        ps = [gm @ q for _, gm, q, _, _ in work]                 # [n, r]
        flat = torch.cat([p.reshape(-1) for p in ps])
        comm.all_reduce(flat, group)
        ps = [_orthogonalize(p, self.eps, self.orthogonalization)
              for p in _split(flat, ps)]
        qs = [gm.T @ p for (_, gm, _, _, _), p in zip(work, ps)]  # [m, r]
        flat = torch.cat([q.reshape(-1) for q in qs])
        comm.all_reduce(flat, group)
        flat /= n_ranks
        for (i, gm, _, entry, perm), p, q in zip(work, ps, _split(flat, qs)):
            g_hat = p @ q.T                                      # [n, m]
            if self.warm_start:
                entry["q"].copy_(q)
            if self.use_error_feedback:
                entry["e"].copy_(gm - g_hat)
            g = grads[i]
            g_hat = g_hat.reshape(_permuted(g.shape, perm))
            if perm:
                g_hat = g_hat.permute(_inverse(perm))
            out[i] = g_hat.to(g.dtype)
        return comm_state, out

    def wire_elements(self, shapes_or_model) -> Tuple[int, int]:
        """(compressed, dense) elements on the wire a step: the bandwidth
        claim, from shapes (in the reference's layout) or a model's
        parameters."""
        dense = compressed = 0
        for shape in self._shapes(shapes_or_model):
            numel = 1
            for s in shape:
                numel *= s
            dense += numel
            plan = self._plan(shape)
            if plan.compress:
                compressed += (plan.n + plan.m) * min(self.rank, plan.n,
                                                      plan.m)
            else:
                compressed += numel
        return compressed, dense


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    return [part.view_as(t)
            for t, part in zip(like, flat.split([t.numel() for t in like]))]


def _inverse(perm) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, d in enumerate(perm):
        inv[d] = i
    return tuple(inv)
