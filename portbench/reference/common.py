"""What the references share: exact fp32 products, the rounding of the
fp8 control and of the bf16 witness, the optimizers and the training
loop that yields a reading."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32 (cuBLAS and cuDNN), and cuDNN's
    heuristics in place of its timed search; restored after."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark,
             torch.get_float32_matmul_precision())
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = b.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.benchmark) = saved[:3]
        torch.set_float32_matmul_precision(saved[3])


#: rounding formats: (dtype, largest finite value; None: no scale)
FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0),
           "e5m2": (torch.float8_e5m2, 57344.0),
           "bf16": (torch.bfloat16, None)}


def rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to ``kind`` (an fp8 format with one scale for the
    tensor, its largest magnitude to the format's largest value; bf16
    without one), back in ``x``'s dtype."""
    dtype, top = FORMATS[kind]
    if top is None:
        return x.to(dtype).to(x.dtype)
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x / scale).to(dtype).to(x.dtype) * scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward operand rounded to ``kind``; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, kind):
        return rounded(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to ``kind``, as the
    backward's products read it."""

    @staticmethod
    def forward(ctx, y, kind):
        ctx.kind = kind
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.kind), None


class Precision:
    """The precision of the products: ``fp32`` (exact), ``fp8`` (the
    control: both operands of every product in e4m3 and the gradients
    flowing into it in e5m2, accumulated in fp32) or ``bf16`` (a witness
    at the configurations' own precision: operands and gradients rounded
    to bf16, accumulated in fp32)."""

    KINDS = {"fp32": None, "fp8": ("e4m3", "e5m2"), "bf16": ("bf16", "bf16")}

    def __init__(self, name: str = "fp32"):
        if name not in self.KINDS:
            raise ValueError(f"precision {name!r}: one of {sorted(self.KINDS)}")
        self.kinds = self.KINDS[name]

    def _in(self, x):
        return _Operand.apply(x, self.kinds[0]) if self.kinds else x

    def _out(self, y):
        return _Output.apply(y, self.kinds[1]) if self.kinds else y

    def linear(self, x, w, b=None):
        y = self._out(F.linear(self._in(x), self._in(w)))
        return y if b is None else y + b

    def matmul(self, a, b):
        return self._out(torch.matmul(self._in(a), self._in(b)))

    def conv2d(self, x, w, stride, padding):
        return self._out(F.conv2d(self._in(x), self._in(w), stride=stride,
                                  padding=padding))


class AdamW:
    """torch's AdamW update, written out (decoupled weight decay, bias
    corrections, ``eps`` after the square root)."""

    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.wd, (self.b1, self.b2), self.eps = (
            lr, weight_decay, betas, eps)
        self.m: Params = {}
        self.v: Params = {}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, t: int) -> None:
        for n, p in params.items():
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v / (1 - self.b2 ** t)).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1 - self.b1 ** t))


class SGD:
    """SGD with momentum, no dampening and no weight decay."""

    def __init__(self, lr: float, momentum: float):
        self.lr, self.momentum = lr, momentum
        self.buf: Params = {}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, t: int) -> None:
        for n, p in params.items():
            b = self.buf.get(n)
            b = grads[n].clone() if b is None else b.mul_(self.momentum).add_(
                grads[n])
            self.buf[n] = b
            p.add_(b, alpha=-self.lr)


def optimizer(spec: dict):
    """The optimizer a configuration's ``optimizer`` entry names."""
    kind = spec["name"]
    if kind == "AdamW":
        return AdamW(spec["lr"], spec["weight_decay"], tuple(spec["betas"]),
                     spec["eps"])
    if kind == "SGD":
        return SGD(spec["lr"], spec["momentum"])
    raise ValueError(f"optimizer {kind!r}")


def train(loss_and_grads: Callable, params0: Params, batches: Iterable,
          opt, views: Callable, keep: Optional[Callable] = None) -> dict:
    """Train from ``params0`` (left as it is) over ``batches`` and return
    the reading: each step's loss, the first gradient's leaf norms, each
    leaf's largest gradient norm over the steps (``grad_max``), the
    change's leaf norms (over ``views(named tensors)``) and the names of
    the leaves of two or more dimensions (``matrices``). ``keep(batch)`` is
    what the step sees of each batch (all of it by default)."""
    params = {n: p.detach().clone() for n, p in params0.items()}
    losses, grad, grad_max = [], None, {}
    for t, batch in enumerate(batches, 1):
        loss, grads = loss_and_grads(params, keep(batch) if keep else batch)
        now = norms(views(grads))
        grad = grad or now
        grad_max = {n: max(v, grad_max.get(n, 0.0)) for n, v in now.items()}
        opt.step(params, grads, t)
        losses.append(float(loss))
    change = norms(views({n: params[n] - params0[n] for n in params}))
    return {"losses": losses, "grad": grad, "grad_max": grad_max,
            "change": change,
            "matrices": [n for n, t in views(params0).items() if t.dim() > 1]}


def norms(tensors: Params) -> Dict[str, float]:
    """fp32 (fp64 accumulated) norm of each tensor, read once."""
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().double().norm()
                        for n in names]).tolist()
    return dict(zip(names, vals))
