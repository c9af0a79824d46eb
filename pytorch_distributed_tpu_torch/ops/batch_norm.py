"""BatchNorm over a stats group: four CUDA kernels and their plain versions.

``models.resnet.BatchNorm`` with a ``stats_group`` of more than one rank
normalizes with the statistics of the whole group's batch, flax's
formula: ``mean = Σx / n``, ``var = max(Σx² / n − mean², 0)``. The work
splits at the group's two all-reduces (the caller's,
``models.resnet._GroupBatchNorm``) into four kernels, over ``x [N, C, H,
W]`` in channels_last memory (a ``[N H W, C]`` matrix):

* :func:`bn_stats`: this rank's ``[Σx (C), Σx² (C), count]`` as one fp32
  buffer of ``2C + 1``, the one the group all-reduces;
* :func:`bn_fwd_elemt`: ``y = (x − mean) weight / sqrt(var + eps) +
  bias`` in x's dtype from the group's sums, with ``mean`` and ``var``;
* :func:`bn_bwd_reduce`: this rank's ``[Σdy, Σdy (x − mean)]`` (2C, the
  copy the group all-reduces) and from them this rank's own ``dweight``
  and ``dbias``;
* :func:`bn_bwd_elemt`: ``dx`` from the group's sums of both.

A CUDA tensor goes to the hand-written kernels of ``csrc/batch_norm.cu``
(bf16, fp16 or fp32 activations whose rows start 16-byte aligned, fp32
statistics and parameters; anything else raises). CPU tensors go to the plain versions (``*_reference``),
which are the plain PyTorch arithmetic the port ran before the kernels,
cut at the same four places: the statistics in fp32, or in the input's
dtype where that is wider (the gloo tests run them in fp64).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build

__all__ = [
    "KERNELS",
    "bn_bwd_elemt",
    "bn_bwd_elemt_reference",
    "bn_bwd_reduce",
    "bn_bwd_reduce_reference",
    "bn_fwd_elemt",
    "bn_fwd_elemt_reference",
    "bn_stats",
    "bn_stats_reference",
]

KERNELS = ("bn_stats", "bn_fwd_elemt", "bn_bwd_reduce", "bn_bwd_elemt")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256     # a CTA of the row kernels: tx channel groups x ty rows
_CTAS_PER_SM = 4   # row slices: one wave (4 CTAs of 256 threads fit an SM)

# Kernel launches, and plain-version calls, since the counts were last set
# to 0, per kernel: shows which path a run went through.
launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)

_DIMS = (0, 2, 3)


# -------------------------------------------------------------------------
# plain versions: the statistics' dtype is fp32, or the input's if wider
# -------------------------------------------------------------------------
def _moments(stats: torch.Tensor, C: int):
    """flax's ``(mean, var, clamped)`` from the group's ``[Σx, Σx², n]``."""
    n = stats[-1]
    mean = stats[:C] / n
    raw = stats[C:2 * C] / n - mean * mean
    return mean, torch.clamp(raw, min=0.0), raw < 0


def _bcast(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def bn_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """``[Σx, Σx², count]`` of ``x``'s rows, ``2C + 1``."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    C = x.shape[1]
    count = torch.full((1,), x.numel() // C, dtype=x.dtype, device=x.device)
    return torch.cat([x.sum(_DIMS), (x * x).sum(_DIMS), count])


def bn_fwd_elemt_reference(x, stats, weight, bias, eps: float):
    """``(y in x's dtype, mean, var)`` from the group's sums."""
    mean, var, _ = _moments(stats, x.shape[1])
    mul = torch.rsqrt(var + eps) * weight
    y = (x.to(stats.dtype) - _bcast(mean)) * _bcast(mul) + _bcast(bias)
    return y.to(x.dtype), mean, var


def bn_bwd_reduce_reference(dy, x, stats, eps: float):
    """``(dweight, dbias, sums)``: this rank's ``sums = [Σdy, Σdy (x −
    mean)]`` and from them ``dbias = Σdy``, ``dweight = Σdy (x − mean) /
    sqrt(var + eps)``."""
    C = x.shape[1]
    mean, var, _ = _moments(stats, C)
    dy = dy.to(stats.dtype)
    xmu = x.to(stats.dtype) - _bcast(mean)
    sums = torch.cat([dy.sum(_DIMS), (dy * xmu).sum(_DIMS)])
    return sums[C:] * torch.rsqrt(var + eps), sums[:C].clone(), sums


def bn_bwd_elemt_reference(dy, x, stats, weight, sums, eps: float):
    """``dx`` in x's dtype from the group's ``sums`` (:func:`bn_bwd_reduce`'s,
    all-reduced): ``weight invstd (dy − Σdy / n − (x − mean) invstd² Σdy (x −
    mean) / n)``, the last term left out where the variance was clamped
    (autograd of the clamp passes no gradient there)."""
    C = x.shape[1]
    mean, var, clamped = _moments(stats, C)
    invstd = torch.rsqrt(var + eps)
    n = stats[-1]
    k = (invstd * invstd * sums[C:] / n).masked_fill(clamped, 0.0)
    dx = _bcast(weight * invstd) * (
        dy.to(stats.dtype) - _bcast(sums[:C] / n)
        - (x.to(stats.dtype) - _bcast(mean)) * _bcast(k))
    return dx.to(x.dtype)


# -------------------------------------------------------------------------
# the kernels
# -------------------------------------------------------------------------
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_GEOMETRY = [_I] * 5     # dtype, tx, ty, gx, gy
# argument types of csrc/batch_norm.cu's entry points; the stream last
_ARGTYPES = {
    "bn_stats": [_P] * 3 + [_LL, _I] + _GEOMETRY + [_P],
    "bn_fwd_elemt": [_P] * 7 + [_LL, _I, _F] + _GEOMETRY + [_P],
    "bn_bwd_reduce": [_P] * 7 + [_LL, _I, _F] + _GEOMETRY + [_P],
    "bn_bwd_elemt": [_P] * 6 + [_LL, _I, _F] + _GEOMETRY + [_P],
}


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("batch_norm")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"{name}_launch")
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(rows: int, C: int, vec: int, sms: int):
    """``(tx, ty, gx, gy)``: tx channel groups of ``vec`` by ty rows a CTA,
    gy channel tiles, gx row slices (also the reductions' partial rows)."""
    groups = C // vec
    tx = min(32, 1 << (groups - 1).bit_length())
    ty = _THREADS // tx
    gy = -(-groups // tx)
    gx = max(1, min(-(-rows // ty), sms * _CTAS_PER_SM // gy))
    return tx, ty, gx, gy


def _plan(name: str, x: torch.Tensor, *others: torch.Tensor):
    """Checks ``x`` (and the activations ``others``, e.g. dy) as the
    kernels take them (a thread loads 16 bytes of a row: ``16 /
    element size`` channels); ``(rows, C, dtype code, tx, ty, gx, gy)``."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes {list(_DTYPE_CODES)} "
                        f"activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be [N, C, H, W] in channels_last "
                         f"memory, got shape {tuple(x.shape)}, strides "
                         f"{x.stride()}")
    for t in others:
        if (t.dtype != x.dtype or t.shape != x.shape or t.device != x.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"{name}: dy must match x ({x.dtype}, "
                             f"{tuple(x.shape)}, channels_last on "
                             f"{x.device}), got {t.dtype}, "
                             f"{tuple(t.shape)}, {t.stride()} on {t.device}")
    C = x.shape[1]
    elt = x.element_size()
    if C * elt % 16 or any(t.data_ptr() % 16 for t in (x, *others)):
        raise ValueError(f"{name}: every row must start 16-byte aligned (C "
                         f"a multiple of {16 // elt} in {x.dtype}, 16-byte "
                         f"aligned data), got C {C} at "
                         f"{[t.data_ptr() % 16 for t in (x, *others)]} "
                         f"bytes past 16")
    rows = x.numel() // C
    geometry = _geometry(rows, C, 16 // elt, _sms(x.device.index or 0))
    return (rows, C, _DTYPE_CODES[x.dtype]) + geometry


def _fp32(name: str, device, **tensors) -> None:
    for key, (t, size) in tensors.items():
        if (t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous() or t.numel() != size):
            raise ValueError(f"{name}: {key} must be {size} contiguous fp32 "
                             f"on {device}, got {t.dtype}, "
                             f"{tuple(t.shape)} on {t.device}")


def _finish(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"BatchNorm kernel {name!r} launch failed: "
                           f"cudaError {rc}")
    launches[name] += 1


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def bn_stats(x: torch.Tensor) -> torch.Tensor:
    """This rank's ``[Σx, Σx², count]`` (``2C + 1``; fp32 from the kernel)."""
    if _on_cpu(x):
        plain_calls["bn_stats"] += 1
        return bn_stats_reference(x)
    rows, C, code, tx, ty, gx, gy = _plan("bn_stats", x)
    stats = torch.empty(2 * C + 1, dtype=torch.float32, device=x.device)
    part = torch.empty(gx * 2 * C, dtype=torch.float32, device=x.device)
    _finish("bn_stats", _kernel_lib().bn_stats_launch(
        x.data_ptr(), part.data_ptr(), stats.data_ptr(), rows, C, code,
        tx, ty, gx, gy, _stream(x)))
    return stats


def bn_fwd_elemt(x, stats, weight, bias, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, var)``: x normalized with the group's sums ``stats``, in
    x's dtype; the batch mean and biased variance (fp32 from the kernel)."""
    if _on_cpu(x, stats, weight, bias):
        plain_calls["bn_fwd_elemt"] += 1
        return bn_fwd_elemt_reference(x, stats, weight, bias, eps)
    rows, C, code, tx, ty, gx, gy = _plan("bn_fwd_elemt", x)
    _fp32("bn_fwd_elemt", x.device, stats=(stats, 2 * C + 1),
          weight=(weight, C), bias=(bias, C))
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _finish("bn_fwd_elemt", _kernel_lib().bn_fwd_elemt_launch(
        x.data_ptr(), y.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), mean.data_ptr(), var.data_ptr(), rows, C, eps, code,
        tx, ty, gx, gy, _stream(x)))
    return y, mean, var


def bn_bwd_reduce(dy, x, stats, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dweight, dbias, sums)``: this rank's ``sums = [Σdy, Σdy (x −
    mean)]`` (2C; the caller all-reduces it) and its own parameter
    gradients."""
    if _on_cpu(dy, x, stats):
        plain_calls["bn_bwd_reduce"] += 1
        return bn_bwd_reduce_reference(dy, x, stats, eps)
    rows, C, code, tx, ty, gx, gy = _plan("bn_bwd_reduce", x, dy)
    _fp32("bn_bwd_reduce", x.device, stats=(stats, 2 * C + 1))
    sums = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    dweight = torch.empty(C, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    part = torch.empty(gx * 2 * C, dtype=torch.float32, device=x.device)
    _finish("bn_bwd_reduce", _kernel_lib().bn_bwd_reduce_launch(
        dy.data_ptr(), x.data_ptr(), stats.data_ptr(), part.data_ptr(),
        sums.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), rows, C, eps,
        code, tx, ty, gx, gy, _stream(x)))
    return dweight, dbias, sums


def bn_bwd_elemt(dy, x, stats, weight, sums, eps: float) -> torch.Tensor:
    """``dx`` in x's dtype from the group's forward ``stats`` and backward
    ``sums`` (both all-reduced)."""
    if _on_cpu(dy, x, stats, weight, sums):
        plain_calls["bn_bwd_elemt"] += 1
        return bn_bwd_elemt_reference(dy, x, stats, weight, sums, eps)
    rows, C, code, tx, ty, gx, gy = _plan("bn_bwd_elemt", x, dy)
    _fp32("bn_bwd_elemt", x.device, stats=(stats, 2 * C + 1),
          weight=(weight, C), sums=(sums, 2 * C))
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    _finish("bn_bwd_elemt", _kernel_lib().bn_bwd_elemt_launch(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), stats.data_ptr(),
        weight.data_ptr(), sums.data_ptr(), rows, C, eps, code, tx, ty,
        gx, gy, _stream(x)))
    return dx
