"""Faults planted in the program's model, to show that the comparison
that decides ``correct`` sees them (``portbench.calibrate --faults``, and
the tests). Each is ``plant(model)``, applied after the weights are
loaded and before the runner warms up and captures, so the timed path
itself carries it.

The ResNet faults sit in the backward of one bottleneck branch's 3x3
convolution (the middle block of the third stage): with each block's last
BatchNorm scale at zero, a branch adds nothing to the first step's loss,
and its backward is seen only through the later checked steps.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

#: the branch convolution the ResNet faults sit in
BRANCH_CONV = "stage2_block3.Conv_1"


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient scaled by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _input_grad(scale: float) -> Callable:
    def plant(model: torch.nn.Module) -> None:
        conv = model.get_submodule(BRANCH_CONV)
        conv.register_forward_pre_hook(
            lambda m, args: (_ScaleGrad.apply(args[0], scale), *args[1:]))
    return plant


def _backward_left_out(model: torch.nn.Module) -> None:
    conv = model.get_submodule(BRANCH_CONV)
    conv.weight.register_hook(torch.zeros_like)
    _input_grad(0.0)(model)


#: name -> plant(model)
PLANTS: Dict[str, Callable[[torch.nn.Module], None]] = {
    "branch_conv_backward_left_out": _backward_left_out,
    "branch_conv_input_grad_halved": _input_grad(0.5),
}
