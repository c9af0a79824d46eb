"""ResNet v1.5 with bottleneck blocks (He et al. 2015; torchvision's
``resnet50``), plain fp32 PyTorch over NHWC images, with the port's
BatchNorm and padding semantics.

* The stem is a 7x7 stride-2 convolution padded 3 on each side, then a
  3x3 stride-2 max-pool padded 1; a block's stride sits on its 3x3
  convolution, padded ``"SAME"`` (an odd total pad goes after, so a
  stride-2 3x3 on an even input pads (0, 1)); the shortcut is a strided
  1x1 convolution and its BatchNorm where the shape changes.
* BatchNorm in training takes the batch's statistics with the biased
  variance (eps 1e-5), over every rank of ``group`` when one is given
  (the sums all-reduced, with their gradients all-reduced back); the
  running statistics are not compared and not kept.
* Global average pool, then the classifier; softmax cross-entropy
  averaged over the rank's rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from portbench.reference.common import Params, Precision

EPS = 1e-5


def _blocks(cfg: dict):
    """``(prefix, cin, filters, stride)`` of every block."""
    cin, width = cfg["width"], cfg["width"]
    for i, count in enumerate(cfg["layers"]):
        for j in range(count):
            yield (f"stage{i}_block{j}.", cin, width * 2 ** i,
                   2 if i > 0 and j == 0 else 1)
            cin = width * 2 ** i * 4


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, kind, value)``: convolutions normal with std
    ``sqrt(2 / (k^2 cout))`` (He's fan-out), BatchNorm scales 1 and
    biases 0 (with ``zero_init_last_bn`` each block's last BatchNorm scale
    0, so that every block starts as the identity: Goyal et al. 2017), the
    classifier normal with std ``1 / sqrt(cin)`` and a zero bias."""
    w = cfg["width"]
    last = 0.0 if cfg.get("zero_init_last_bn") else 1.0

    def conv(name, cout, cin, k):
        return (name, (cout, cin, k, k), "normal", math.sqrt(2.0 / (k * k * cout)))

    def bn(name, c, scale=1.0):
        return [(name + ".weight", (c,), "const", scale),
                (name + ".bias", (c,), "const", 0.0)]

    specs = [conv("conv_init.weight", w, 3, 7)] + bn("bn_init", w)
    for h, cin, f, stride in _blocks(cfg):
        specs += [conv(h + "Conv_0.weight", f, cin, 1)] + bn(h + "BatchNorm_0", f)
        specs += [conv(h + "Conv_1.weight", f, f, 3)] + bn(h + "BatchNorm_1", f)
        specs += [conv(h + "Conv_2.weight", 4 * f, f, 1)] + bn(h + "BatchNorm_2", 4 * f, last)
        if stride != 1 or cin != 4 * f:
            specs += [conv(h + "downsample.weight", 4 * f, cin, 1)]
            specs += bn(h + "downsample_bn", 4 * f)
        cin = 4 * f
    classes = cfg["num_classes"]
    specs += [("fc.weight", (classes, cin), "normal", 1.0 / math.sqrt(cin)),
              ("fc.bias", (classes,), "const", 0.0)]
    return specs


def views(tensors: Params) -> Params:
    return dict(tensors)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sum(x, group):
    return x if group is None else _AllReduceSum.apply(x, group)


def batch_norm(x, w, b, group=None):
    C = x.shape[1]
    n = x.numel() // C * (1 if group is None else dist.get_world_size(group))
    mean = _sum(x.sum((0, 2, 3)), group) / n
    centred = x - mean.view(1, C, 1, 1)
    var = _sum((centred * centred).sum((0, 2, 3)), group) / n
    return centred * (torch.rsqrt(var + EPS) * w).view(1, C, 1, 1) \
        + b.view(1, C, 1, 1)


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, prec: Precision):
    k = w.shape[-1]
    top, bottom = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return prec.conv2d(x, w, stride, (top, left))


def logits(p: Params, images, cfg: dict, prec: Precision, group=None):
    x = images.permute(0, 3, 1, 2)
    x = prec.conv2d(x, p["conv_init.weight"], 2, (3, 3))
    x = F.relu(batch_norm(x, p["bn_init.weight"], p["bn_init.bias"], group))
    x = F.max_pool2d(x, 3, 2, padding=1)

    def bn(y, name):
        return batch_norm(y, p[name + ".weight"], p[name + ".bias"], group)

    for h, cin, f, stride in _blocks(cfg):
        y = F.relu(bn(_conv(x, p[h + "Conv_0.weight"], 1, prec), h + "BatchNorm_0"))
        y = F.relu(bn(_conv(y, p[h + "Conv_1.weight"], stride, prec), h + "BatchNorm_1"))
        y = bn(_conv(y, p[h + "Conv_2.weight"], 1, prec), h + "BatchNorm_2")
        if h + "downsample.weight" in p:
            x = bn(_conv(x, p[h + "downsample.weight"], stride, prec),
                   h + "downsample_bn")
        x = F.relu(y + x)
    return prec.linear(x.mean((2, 3)), p["fc.weight"], p["fc.bias"])


def loss_and_grads(cfg: dict, prec: Precision,
                   group: Optional[dist.ProcessGroup] = None):
    """``f(params, (images, labels)) -> (mean loss, grads)``: the rank's
    own mean loss, and with ``group`` the gradients averaged over it."""

    def f(params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        images, labels = batch
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        images = images.to(leaves["fc.weight"].dtype)
        loss = F.cross_entropy(logits(leaves, images, cfg, prec, group),
                               labels.long())
        loss.backward()
        grads = {n: t.grad for n, t in leaves.items()}
        if group is not None:
            names = list(grads)
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            flat /= dist.get_world_size(group)
            grads = dict(zip(names, (g.view_as(grads[n]) for n, g in zip(
                names, flat.split([grads[n].numel() for n in names])))))
        return loss.detach(), grads

    return f
