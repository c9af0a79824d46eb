"""ResNet family (v1.5) of the port: NHWC input, flax's semantics.

Port of ``pytorch_distributed_tpu/models/resnet.py``: ``BasicBlock``,
``Bottleneck``, ``ResNet`` and ``resnet18/34/50/101``, with the same
parameter names as the flax tree (``conv_init``, ``bn_init``,
``stage{i}_block{j}.{Conv_n, BatchNorm_n, downsample, downsample_bn}``,
``fc``), so ``models.convert`` maps one onto the other name by name.

What it keeps of flax, where torch's own modules would differ:

* the input is NHWC, as the datasets yield it; ``x.permute(0, 3, 1, 2)`` of
  an NHWC tensor is already ``channels_last`` in memory, and the conv
  weights are kept ``channels_last`` too, so cuDNN runs NHWC throughout;
* convolutions pad ``"SAME"``: a 3x3 stride-2 conv on an even input pads
  (0, 1), not torch's symmetric 1 (:func:`same_padding`); the 7x7 stem pads
  (3, 3) explicitly and the 1x1 convs not at all;
* ``dtype`` is the compute dtype and ``param_dtype`` that of the
  parameters: each conv casts its weight to ``dtype``; the global average
  pool runs in ``dtype``, then the features are cast to ``param_dtype`` for
  the classifier (``fc``) and the loss;
* :class:`BatchNorm` is ``flax.linen.BatchNorm``: fp32 statistics (at
  least), the biased variance for the normalization and for the running
  variance (torch's modules update the running variance with the unbiased
  one),
  ``ra = m * ra + (1 - m) * batch`` with flax's momentum 0.9, and the
  statistics of the whole global batch when a process group is bound
  (``stats_group``; ``DataParallel`` binds its dp group), which is what
  the JAX package's global-view step computes. Under a gradient
  communication hook the reference computes per dp shard, and a
  BatchNorm takes the statistics of its own rows unless the model was
  built with ``bn_axis_name`` (flax's ``axis_name``): ``Trainer`` then
  binds the group of that mesh axis only where it is set.

Weights are drawn as flax draws them (conv ``variance_scaling(2.0,
"fan_out", "normal")``, Dense LeCun-normal with zero bias, the last BN
scale of each block zero) from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.observability import spans
from pytorch_distributed_tpu_torch.ops import batch_norm

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "Bottleneck",
    "Conv",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "same_padding",
]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of flax/XLA ``"SAME"`` along one dimension:
    the output has ``ceil(size / stride)`` positions and the odd pad goes
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2-D convolution over channels_last activations, flax
    ``nn.Conv`` semantics. ``padding`` is ``"SAME"`` or an explicit
    ``(before, after)`` pair used on both spatial dimensions."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel, kernel, dtype=param_dtype, device=device,
        ).to(memory_format=torch.channels_last))

    def _pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right)."""
        if self.padding == "SAME":
            return (same_padding(h, self.kernel, self.stride)
                    + same_padding(w, self.kernel, self.stride))
        return tuple(self.padding) * 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom, left, right = self._pads(x.shape[2], x.shape[3])
        w = self.weight.to(self.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


class _GroupBatchNorm(torch.autograd.Function):
    """BatchNorm of ``x`` with the statistics of ``group``'s whole batch:
    ``(y, mean, var)``. The four kernels of ``ops.batch_norm`` (their plain
    versions for CPU tensors), with the group's sums all-reduced between
    them: ``[Σx, Σx², n]`` in the forward, ``[Σdy, Σdy (x − mean)]`` in the
    backward. The gradients of ``weight`` and ``bias`` are this rank's own
    (the strategy reduces them with the others); ``x``'s is the group's."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        stats = batch_norm.bn_stats(x)
        dist.all_reduce(stats, group=group)
        y, mean, var = batch_norm.bn_fwd_elemt(x, stats, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _mean, _var):
        x, weight, stats = ctx.saved_tensors
        # the kernels read dy as they read x (a copy where it is not)
        dy = dy.contiguous(memory_format=torch.channels_last)
        dweight, dbias, sums = batch_norm.bn_bwd_reduce(dy, x, stats,
                                                        ctx.eps)
        dist.all_reduce(sums, group=ctx.group)
        dx = batch_norm.bn_bwd_elemt(dy, x, stats, weight, sums, ctx.eps)
        return dx, dweight, dbias, None, None


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over channels (dim 1), NCHW-shaped input.

    Train mode normalizes with the batch's statistics, taken in fp32 (or in
    the input's dtype where that is wider) with the biased variance, and
    updates ``running_mean`` / ``running_var`` as ``momentum * ra + (1 -
    momentum) * batch`` (the biased variance too). With ``stats_group`` set
    to a process group of more than one rank, the statistics are those of
    the batch over every rank of the group: the ranks' ``[sum, sum of
    squares, count]`` are all-reduced, and the variance is ``E[x^2] -
    E[x]^2`` clipped at zero, as flax computes it (``_GroupBatchNorm``: the
    kernels of ``ops.batch_norm`` on the card, their plain versions on the
    CPU; the backward all-reduces its sums the same way). On one rank
    the normalization runs through ``F.batch_norm`` (cuDNN on the card),
    and the statistics for the buffer update are read from it. Eval mode
    normalizes with the running statistics. The output is in the input's
    dtype; the scale, bias and running statistics stay in ``param_dtype``.
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, param_dtype=torch.float32,
                 device=None, axis_name: Optional[str] = None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        #: the mesh axis whose group takes the statistics under a comm hook
        self.axis_name = axis_name
        kw = dict(dtype=param_dtype, device=device)
        self.weight = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("running_mean", torch.zeros(features, **kw))
        self.register_buffer("running_var", torch.ones(features, **kw))
        self.stats_group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the statistics' dtype: F.batch_norm takes fp32 parameters beside
        # 16-bit inputs, and fp64 ones beside fp64 inputs
        sdt = torch.promote_types(x.dtype, torch.float32)
        weight, bias = self.weight.to(sdt), self.bias.to(sdt)
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(sdt),
                                self.running_var.to(sdt), weight, bias,
                                False, 0.0, self.epsilon)
        group = self.stats_group
        grouped = group is not None and dist.get_world_size(group) > 1
        if grouped:
            # the span bn_group (observability.spans): the group's sums,
            # the normalization and the buffer update, forward and backward
            x, weight, bias = spans.enter("bn_group", x, weight, bias)
            y, mean, var = _GroupBatchNorm.apply(x, weight, bias,
                                                 self.epsilon, group)
        else:
            y, mean, var = self._local_batch_norm(x, weight, bias)
        with torch.no_grad():   # m * ra + (1 - m) * batch, one kernel each
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    1 - self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   1 - self.momentum)
        return spans.leave("bn_group", y) if grouped else y

    def _local_batch_norm(self, x, weight, bias):
        # F.batch_norm at momentum 1 leaves the batch mean and the unbiased
        # batch variance in the buffers it is given; n / (n - 1) undone
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(weight)
        var = torch.ones_like(weight)
        y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.epsilon)
        return y, mean, var * ((n - 1) / n)


class _Block(nn.Module):
    """A residual block's shortcut: the input, or a strided 1x1 conv and
    its BN (``downsample``, ``downsample_bn``) where the shape changes."""

    def _downsample(self, cin, cout, strides, conv, norm):
        self.downsample = self.downsample_bn = None
        if strides != 1 or cin != cout:
            self.downsample = conv(cin, cout, 1, strides)
            self.downsample_bn = norm(cout)

    def _residual(self, x):
        if self.downsample is None:
            return x
        return self.downsample_bn(self.downsample(x))


class BasicBlock(_Block):
    """Two 3x3 convs (the stride on the first); ``expansion = 1``."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int, **kw):
        super().__init__()
        conv, norm = _layers(kw)
        self.Conv_0 = conv(cin, filters, 3, strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters)
        self._downsample(cin, filters, strides, conv, norm)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(y + self._residual(x))

    def last_norm(self) -> BatchNorm:
        return self.BatchNorm_1


class Bottleneck(_Block):
    """1x1, 3x3 (v1.5: the stride here), 1x1 to ``4 * filters``."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int, **kw):
        super().__init__()
        conv, norm = _layers(kw)
        self.Conv_0 = conv(cin, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.BatchNorm_2 = norm(filters * 4)
        self._downsample(cin, filters * 4, strides, conv, norm)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(y + self._residual(x))

    def last_norm(self) -> BatchNorm:
        return self.BatchNorm_2


def _layers(kw):
    """The block's conv and norm constructors, bound to the model's dtypes,
    BN momentum and device."""
    dtype, param_dtype, device = kw["dtype"], kw["param_dtype"], kw["device"]

    def conv(cin, cout, kernel, stride=1):
        return Conv(cin, cout, kernel, stride, dtype=dtype,
                    param_dtype=param_dtype, device=device)

    def norm(features):
        return BatchNorm(features, momentum=kw["bn_momentum"],
                         param_dtype=param_dtype, device=device,
                         axis_name=kw.get("bn_axis_name"))

    return conv, norm


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC images: ``forward(x [N, H, W, 3]) -> logits
    [N, num_classes]`` in ``param_dtype``.

    Args:
      stage_sizes: blocks per stage, e.g. (2, 2, 2, 2) for ResNet-18.
      block: ``BasicBlock`` or ``Bottleneck``.
      num_classes: classifier width.
      num_filters: the first stage's width (64 in the published models).
      cifar_stem: a 3x3 stride-1 stem and no max-pool (32x32 inputs).
      dtype: compute dtype; parameters and BN statistics stay
        ``param_dtype``.
      bn_momentum: flax's BN momentum (the running average keeps this much).
      bn_axis_name: the mesh axis (``"dp"``) over which BatchNorm takes its
        statistics under a gradient communication hook; None: each rank's
        own rows there (without a hook ``DataParallel`` always takes the
        global batch's).
      device: ``None`` is the CUDA card (raises without one).
      seed: seed of the ``torch.Generator`` the weights are drawn from.
    """

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock,
                 num_classes: int = 1000, *, num_filters: int = 64,
                 cifar_stem: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, bn_momentum: float = 0.9,
                 bn_axis_name: Optional[str] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.param_dtype = dtype, param_dtype
        self.cifar_stem = cifar_stem
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  bn_momentum=bn_momentum, bn_axis_name=bn_axis_name)
        conv, norm = _layers(kw)
        if cifar_stem:
            self.conv_init = conv(3, num_filters, 3)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, (3, 3), dtype=dtype,
                                  param_dtype=param_dtype, device=device)
        self.bn_init = norm(num_filters)
        self.blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                b = block(cin, num_filters * 2**i,
                          2 if i > 0 and j == 0 else 1, **kw)
                self.add_module(f"stage{i}_block{j}", b)
                self.blocks.append(b)
                cin = num_filters * 2**i * block.expansion
        self.fc = nn.Linear(cin, num_classes, dtype=param_dtype,
                            device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: conv ``variance_scaling(2.0, "fan_out",
        "normal")``, LeCun-normal ``fc`` (truncated at two sigma) with zero
        bias, unit BN scales except each block's last (zero), zero BN
        biases, running statistics at 0 and 1."""
        for m in self.modules():
            if isinstance(m, Conv):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)),
                                 generator=generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for b in self.blocks:
            b.last_norm().weight.zero_()
        std = self.fc.in_features ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.fc.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.fc.bias.zero_()

    def batch_norms(self):
        """Every :class:`BatchNorm` of the model."""
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC -> channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)   # pads with -inf
        for b in self.blocks:
            x = b(x)
        x = x.mean(dim=(2, 3)).to(self.param_dtype)
        return self.fc(x)


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, num_classes, **kw)
