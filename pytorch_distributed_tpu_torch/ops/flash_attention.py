"""Flash attention over ``[B, T, H, D]``: the CUDA kernels + plain ops.

Port of ``pytorch_distributed_tpu/ops/flash_attention.py``. The public API
keeps the JAX package's dispatch rules:

* ``causal=True`` without positions and Tq == Tk takes the pruned static
  causal path: forward B1, backward B2 (dq) and B3 (dk/dv), hand-written in
  ``csrc/flash_attention_causal.cu``. ``_FlashCausal`` is its
  ``autograd.Function``: the forward saves ``q, k, v, out, lse``; the
  backward computes ``delta = rowsum(do * out)`` in fp32 as a plain op (it
  sits outside the kernels in JAX too) and runs B2 and B3.
* rectangular causal (Tq != Tk) becomes positions ``arange(Tq)`` and
  ``arange(Tk)``;
* explicit ``q_pos``/``kv_pos`` always mask (keep = q_pos >= kv_pos), with
  or without ``causal``; ``causal=False`` without positions is unmasked.

The last two are the position-masked route: forward B4, backward B5 (dq)
and B6 (dk/dv), hand-written in ``csrc/flash_attention_masked.cu``.
``_FlashMasked`` is its ``autograd.Function``, built as ``_FlashCausal``.
Its kernels are also the local op of context parallelism's ring
(``parallel.context_parallel``), which calls them once per hop with the
hop's global positions and, in the forward, fp32 partial outputs.

In bf16/fp16, B1-B6 run on the Hopper route (``wgmma`` tiles fed by TMA,
``csrc/flash_sm90.cuh``): their q, k, v (and do) need D % 8 == 0 and
16-byte aligned bases and strides (``tma_layout_error``), and a call that
breaks the rule raises ``ValueError``; fp32 keeps the CUDA-core kernels.
The Hopper B2, B3, B5 and B6 round ds (and B3 and B6 p) to the input dtype
before their tensor-core products (the TPU kernels and the plain versions
keep them fp32).

Every kernel has a plain PyTorch version beside it (``*_reference``): the
same blocked online-softmax arithmetic in torch ops. A wrapper takes it only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``block_q``/``block_k`` tile the plain versions; the CUDA kernels' tiles
are fixed (64 x 64; 128 rows by 64 on the Hopper route).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_causal_fwd",
    "flash_causal_fwd_reference",
    "flash_causal_dq",
    "flash_causal_dq_reference",
    "flash_causal_dkv",
    "flash_causal_dkv_reference",
    "flash_masked_fwd",
    "flash_masked_fwd_reference",
    "flash_masked_dq",
    "flash_masked_dq_reference",
    "flash_masked_dkv",
    "flash_masked_dkv_reference",
    "tma_layout_error",
]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_SIZE = 128  # the kernels stage D in shared memory as 64 or 128
_LIB = "flash_attention_causal"
_MASKED_LIB = "flash_attention_masked"

# Kernel launches (not plain-version calls) since the counts were last set
# to 0, per kernel: shows that a run went through the CUDA kernels. B1-B3
# count under fwd/dq/dkv, B4-B6 under mfwd/mdq/mdkv.
launches = {"fwd": 0, "dq": 0, "dkv": 0, "mfwd": 0, "mdq": 0, "mdkv": 0}


def _scale(D: int) -> float:
    return 1.0 / D ** 0.5


# -------------------------------------------------------------------------
# plain versions of B1-B3 (layouts as the kernels: [B, T, H, D] in and out,
# lse/delta [B, H, T] fp32)
# -------------------------------------------------------------------------
def flash_causal_fwd_reference(q, k, v, block_q: int = 64, block_k: int = 64
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's arithmetic: Q tiles of ``block_q`` rows, each with an online
    softmax over the K/V tiles that reach it (pruned), fp32 m/l/acc, p
    rounded to v's dtype before the PV product."""
    B, T, H, D = q.shape
    scale = _scale(D)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = torch.empty(B, H, T, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    for q0 in range(0, T, block_q):
        q1 = min(q0 + block_q, T)
        qb = qt[:, :, q0:q1].float()
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, q1 - q0), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, q1, block_k):
            k1 = min(k0 + block_k, T)
            kb = kt[:, :, k0:k1].float()
            vb = vt[:, :, k0:k1]
            keep = _causal_keep(q0, q1, k0, k1, q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
            s = torch.where(keep, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        safe = torch.clamp(l, min=1e-30)
        out[:, :, q0:q1] = (acc / safe[..., None]).to(q.dtype)
        lse[:, :, q0:q1] = torch.where(l > 0, m + torch.log(safe), _NEG_INF)
    return out.transpose(1, 2), lse


def _probs(qb, kb, lse_b, keep, scale):
    """p recomputed from the saved lse, masked by ``keep`` (None: not
    masked), with the dead-row guard."""
    s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
    p = torch.exp(s - lse_b[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    return torch.where(lse_b[..., None] <= _NEG_INF / 2, 0.0, p)


def _causal_keep(q0, q1, k0, k1, device):
    rows = torch.arange(q0, q1, device=device)
    return rows[:, None] >= torch.arange(k0, k1, device=device)[None, :]


def flash_causal_dq_reference(q, k, v, do, lse, delta, block_q: int = 64,
                              block_k: int = 64) -> torch.Tensor:
    """B2's arithmetic: dq = sum_k ds k with ds = p (dp - delta) scale,
    q-major over the pruned tile pairs, all products in fp32."""
    B, T, H, D = q.shape
    scale = _scale(D)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dq = torch.empty(B, H, T, D, dtype=q.dtype, device=q.device)
    for q0 in range(0, T, block_q):
        q1 = min(q0 + block_q, T)
        qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
        lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        for k0 in range(0, q1, block_k):
            k1 = min(k0 + block_k, T)
            kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
            p = _probs(qb, kb, lse_b, _causal_keep(q0, q1, k0, k1, q.device),
                       scale)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dq[:, :, q0:q1] = acc.to(q.dtype)
    return dq.transpose(1, 2)


def flash_causal_dkv_reference(q, k, v, do, lse, delta, block_q: int = 64,
                               block_k: int = 64
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3's arithmetic: dv = sum_q p^T do, dk = sum_q ds^T q, kv-major from
    ``qi_first = k0 // block_q`` to the last Q tile, all in fp32."""
    B, T, H, D = q.shape
    scale = _scale(D)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dk = torch.empty(B, H, T, D, dtype=k.dtype, device=q.device)
    dv = torch.empty(B, H, T, D, dtype=v.dtype, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
        dk_acc = torch.zeros(B, H, k1 - k0, D, dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range((k0 // block_q) * block_q, T, block_q):
            q1 = min(q0 + block_q, T)
            qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
            lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
            p = _probs(qb, kb, lse_b, _causal_keep(q0, q1, k0, k1, q.device),
                       scale)
            dv_acc = dv_acc + torch.einsum("bhqk,bhqd->bhkd", p, dob)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bhqk,bhqd->bhkd", ds, qb)
        dk[:, :, k0:k1] = dk_acc.to(k.dtype)
        dv[:, :, k0:k1] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2), dv.transpose(1, 2)


# -------------------------------------------------------------------------
# kernel wrappers: CPU tensors -> plain version, CUDA tensors -> the kernel
# -------------------------------------------------------------------------
def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for name, args in signatures:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


_TAIL = [_STRIDES, _I, _I, _I, _I, _F, _I, _P]   # B, T, H, D, scale, dtype, stream
# the extern "C" entry points of csrc/flash_attention_causal.cu
CAUSAL_SIGNATURES = (
    ("flash_causal_fwd_launch", [_P] * 5 + _TAIL),
    ("flash_causal_dq_launch", [_P] * 7 + _TAIL),
    ("flash_causal_dkv_launch", [_P] * 8 + _TAIL),
)


_MASKED_DIMS = [_STRIDES, _I, _I, _I, _I, _I, _F, _I]  # B, Tq, Tk, H, D, scale, dtype
# the extern "C" entry points of csrc/flash_attention_masked.cu
MASKED_SIGNATURES = (
    ("flash_masked_fwd_launch", [_P] * 7 + _MASKED_DIMS + [_I, _P]),  # out_fp32
    ("flash_masked_dq_launch", [_P] * 9 + _MASKED_DIMS + [_P]),
    ("flash_masked_dkv_launch", [_P] * 10 + _MASKED_DIMS + [_P]),
)


def _kernel_lib() -> ctypes.CDLL:
    return _bind(_build.load(_LIB), CAUSAL_SIGNATURES)


def _masked_lib() -> ctypes.CDLL:
    return _bind(_build.load(_MASKED_LIB), MASKED_SIGNATURES)


def _check(name: str, q_side, kv_side, stats=(), same_t: bool = False):
    """Shape, dtype, device and layout checks for a kernel launch:
    ``q_side`` tensors are ``[B, Tq, H, D]`` (q, do), ``kv_side`` ones
    ``[B, Tk, H, D]`` (k, v), ``stats`` fp32 ``[B, H, Tq]`` (lse, delta).
    Returns ``(B, Tq, Tk, H, D)``."""
    q = q_side[0]
    dev = q.device
    operands = (*q_side, *kv_side)
    if dev.type != "cuda" or any(t.device != dev for t in operands + tuple(stats)):
        raise ValueError(
            f"{name}: all tensors must be on one CUDA device (or all on the "
            "CPU for the plain version)"
        )
    if q.dim() != 4 or kv_side[0].dim() != 4:
        raise ValueError(f"{name}: operands must be [B, T, H, D], got "
                         f"{tuple(q.shape)} and {tuple(kv_side[0].shape)}")
    B, Tq, H, D = q.shape
    Tk = kv_side[0].shape[1]
    if same_t and Tq != Tk:
        raise ValueError(f"{name}: causal self-attention needs Tq == Tk, got "
                         f"{Tq} and {Tk}")
    for t, want in [(t, (B, Tq, H, D)) for t in q_side] + \
            [(t, (B, Tk, H, D)) for t in kv_side]:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                             f"expected {want}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in operands):
        raise TypeError(
            f"{name}: q, k, v (and do) must share one of "
            f"{list(_DTYPE_CODES)}, got {[t.dtype for t in operands]}"
        )
    if D > _MAX_HEAD_SIZE:
        raise ValueError(f"{name}: head size {D} > {_MAX_HEAD_SIZE}")
    if any(t.stride(-1) != 1 for t in operands):
        raise ValueError(f"{name}: operands must be contiguous along D")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Tq) or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: lse/delta must be contiguous fp32 [B, H, Tq] = "
                f"{(B, H, Tq)}, got {t.dtype} {tuple(t.shape)}"
            )
    return B, Tq, Tk, H, D


def tma_layout_error(shape, strides, elt: int, ptr: int) -> Optional[str]:
    """The rule that the Hopper route's TMA loads (B1-B6 in bf16/fp16)
    put on a ``[B, T, H, D]`` operand, as a pure function of its shape, its
    strides in elements, its element size in bytes and its address: D a
    multiple of 8, a 16-byte aligned base, and the batch, time and head
    strides of every dimension longer than 1 a multiple of 16 bytes.
    Returns the rule broken, or None."""
    D = shape[-1]
    if D % 8:
        return f"head size D={D} must be a multiple of 8"
    if ptr % 16:
        return f"base address {ptr:#x} must be 16-byte aligned"
    for dim, size, stride in zip("BTH", shape[:3], strides[:3]):
        if size > 1 and (stride * elt) % 16:
            return (f"the {dim} stride of {stride} elements ({stride * elt} "
                    "bytes) must be a multiple of 16 bytes")
    return None


def _tma_error(t) -> Optional[str]:
    return tma_layout_error(tuple(t.shape), t.stride(), t.element_size(),
                            t.data_ptr())


def _check_tma(name: str, *tensors) -> None:
    """bf16/fp16 B1-B6 read their operands by TMA: ValueError naming
    the rule that an operand breaks."""
    if tensors[0].dtype == torch.float32:
        return
    for t in tensors:
        err = _tma_error(t)
        if err is not None:
            raise ValueError(f"{name}: {t.dtype} operands are read by TMA: "
                             f"{err}")


def tma_ready(do):
    """The upstream gradient as the backward kernels take it: contiguous
    along D, and for 16-bit inputs in TMA's layout (a copy where it is
    not)."""
    if do.stride(-1) != 1 or (do.dtype != torch.float32
                              and _tma_error(do) is not None):
        return do.contiguous()
    return do


def _strides(*tensors):
    flat = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _finish(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"flash attention kernel {name!r} launch failed: "
                           f"cudaError {rc}")
    launches[name] += 1


def flash_causal_fwd(q, k, v, block_q: int = 64, block_k: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: ``(out [B, T, H, D] in q's dtype, lse [B, H, T] fp32)``."""
    if _on_cpu(q, k, v):
        return flash_causal_fwd_reference(q, k, v, block_q, block_k)
    B, T, _, H, D = _check("flash_causal_fwd", (q,), (k, v), same_t=True)
    _check_tma("flash_causal_fwd", q, k, v)
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = _kernel_lib().flash_causal_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), B, T, H, D, _scale(D),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _finish("fwd", rc)
    return out, lse


def flash_causal_dq(q, k, v, do, lse, delta, block_q: int = 64,
                    block_k: int = 64) -> torch.Tensor:
    """B2: ``dq [B, T, H, D]`` in q's dtype."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_causal_dq_reference(q, k, v, do, lse, delta, block_q,
                                         block_k)
    B, T, _, H, D = _check("flash_causal_dq", (q, do), (k, v), (lse, delta),
                           same_t=True)
    _check_tma("flash_causal_dq", q, k, v, do)
    dq = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    rc = _kernel_lib().flash_causal_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), B, T, H, D, _scale(D),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _finish("dq", rc)
    return dq


def flash_causal_dkv(q, k, v, do, lse, delta, block_q: int = 64,
                     block_k: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: ``(dk, dv)``, each ``[B, T, H, D]`` in k's and v's dtype."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_causal_dkv_reference(q, k, v, do, lse, delta, block_q,
                                          block_k)
    B, T, _, H, D = _check("flash_causal_dkv", (q, do), (k, v), (lse, delta),
                           same_t=True)
    _check_tma("flash_causal_dkv", q, k, v, do)
    dk = torch.empty(B, T, H, D, dtype=k.dtype, device=q.device)
    dv = torch.empty(B, T, H, D, dtype=v.dtype, device=q.device)
    rc = _kernel_lib().flash_causal_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), B, T, H, D, _scale(D),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _finish("dkv", rc)
    return dk, dv


# -------------------------------------------------------------------------
# the differentiable pruned causal path
# -------------------------------------------------------------------------
class _FlashCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k):
        out, lse = flash_causal_fwd(q, k, v, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = tma_ready(do)
        delta = attention_delta(do, out)
        dq = flash_causal_dq(q, k, v, do, lse, delta, *ctx.blocks)
        dk, dv = flash_causal_dkv(q, k, v, do, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


# -------------------------------------------------------------------------
# plain versions of B4-B6: every tile pair, keep = q_pos >= kv_pos (no
# positions: unmasked), a pair skipped whole when max(q_pos of the Q tile)
# < min(kv_pos of the K tile), as the kernels skip it
# -------------------------------------------------------------------------
def _tile_keep(q_pos, kv_pos, q0, q1, k0, k1):
    """``(skip, keep)`` for one tile pair; ``keep`` is None unmasked."""
    if q_pos is None:
        return False, None
    qp, kp = q_pos[q0:q1], kv_pos[k0:k1]
    if bool(qp.max() < kp.min()):
        return True, None
    return False, qp[:, None] >= kp[None, :]


def _flat_positions(q_pos, kv_pos, Tq: int, Tk: int):
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("q_pos and kv_pos go together: give both or neither")
    if q_pos is None:
        return None, None
    q_pos, kv_pos = q_pos.reshape(-1), kv_pos.reshape(-1)
    if q_pos.numel() != Tq or kv_pos.numel() != Tk:
        raise ValueError(f"positions of length {q_pos.numel()} and "
                         f"{kv_pos.numel()} for Tq={Tq}, Tk={Tk}")
    return q_pos, kv_pos


def flash_masked_fwd_reference(q, k, v, q_pos=None, kv_pos=None,
                               block_q: int = 64, block_k: int = 64,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4's arithmetic: Q tiles of ``block_q`` rows, each with an online
    softmax over every K/V tile it does not skip, fp32 m/l/acc, p rounded to
    v's dtype before the PV product. Returns ``(out [B, Tq, H, D] in
    out_dtype or q's, lse [B, H, Tq] fp32)``; a row that sees no key gets
    out = 0 and lse = -1e30."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q_pos, kv_pos = _flat_positions(q_pos, kv_pos, Tq, Tk)
    scale = _scale(D)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = torch.empty(B, H, Tq, D, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, block_q):
        q1 = min(q0 + block_q, Tq)
        qb = qt[:, :, q0:q1].float()
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, q1 - q0), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Tk, block_k):
            k1 = min(k0 + block_k, Tk)
            skip, keep = _tile_keep(q_pos, kv_pos, q0, q1, k0, k1)
            if skip:
                continue
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kt[:, :, k0:k1].float()) * scale
            if keep is not None:
                s = torch.where(keep, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if keep is not None:
                p = torch.where(keep, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                vt[:, :, k0:k1].float())
            m = m_new
        safe = torch.clamp(l, min=1e-30)
        out[:, :, q0:q1] = (acc / safe[..., None]).to(out.dtype)
        lse[:, :, q0:q1] = torch.where(l > 0, m + torch.log(safe), _NEG_INF)
    return out.transpose(1, 2), lse


def flash_masked_dq_reference(q, k, v, do, lse, delta, q_pos=None,
                              kv_pos=None, block_q: int = 64,
                              block_k: int = 64) -> torch.Tensor:
    """B5's arithmetic: dq = sum_k ds k with ds = p (dp - delta) scale over
    the tile pairs not skipped, q-major, all products in fp32."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q_pos, kv_pos = _flat_positions(q_pos, kv_pos, Tq, Tk)
    scale = _scale(D)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dq = torch.empty(B, H, Tq, D, dtype=q.dtype, device=q.device)
    for q0 in range(0, Tq, block_q):
        q1 = min(q0 + block_q, Tq)
        qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
        lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        for k0 in range(0, Tk, block_k):
            k1 = min(k0 + block_k, Tk)
            skip, keep = _tile_keep(q_pos, kv_pos, q0, q1, k0, k1)
            if skip:
                continue
            kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
            p = _probs(qb, kb, lse_b, keep, scale)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dq[:, :, q0:q1] = acc.to(q.dtype)
    return dq.transpose(1, 2)


def flash_masked_dkv_reference(q, k, v, do, lse, delta, q_pos=None,
                               kv_pos=None, block_q: int = 64,
                               block_k: int = 64
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's arithmetic: dv = sum_q p^T do, dk = sum_q ds^T q, K-major over
    the tile pairs not skipped, all in fp32."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q_pos, kv_pos = _flat_positions(q_pos, kv_pos, Tq, Tk)
    scale = _scale(D)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dk = torch.empty(B, H, Tk, D, dtype=k.dtype, device=q.device)
    dv = torch.empty(B, H, Tk, D, dtype=v.dtype, device=q.device)
    for k0 in range(0, Tk, block_k):
        k1 = min(k0 + block_k, Tk)
        kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
        dk_acc = torch.zeros(B, H, k1 - k0, D, dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, Tq, block_q):
            q1 = min(q0 + block_q, Tq)
            skip, keep = _tile_keep(q_pos, kv_pos, q0, q1, k0, k1)
            if skip:
                continue
            qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
            lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
            p = _probs(qb, kb, lse_b, keep, scale)
            dv_acc = dv_acc + torch.einsum("bhqk,bhqd->bhkd", p, dob)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bhqk,bhqd->bhkd", ds, qb)
        dk[:, :, k0:k1] = dk_acc.to(k.dtype)
        dv[:, :, k0:k1] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2), dv.transpose(1, 2)


# -------------------------------------------------------------------------
# B4-B6 wrappers: CPU tensors -> plain version, CUDA tensors -> the kernel
# -------------------------------------------------------------------------
def _device_positions(q_pos, kv_pos, Tq: int, Tk: int, device):
    """int32 contiguous positions on ``device`` (or two Nones)."""
    q_pos, kv_pos = _flat_positions(q_pos, kv_pos, Tq, Tk)
    if q_pos is None:
        return None, None
    return tuple(p.to(device=device, dtype=torch.int32).contiguous()
                 for p in (q_pos, kv_pos))


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_masked_fwd(q, k, v, q_pos=None, kv_pos=None, block_q: int = 64,
                     block_k: int = 64, out_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: ``(out [B, Tq, H, D] in out_dtype or q's dtype, lse [B, H, Tq]
    fp32)``; ``out_dtype`` may be q's dtype or float32."""
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: q's dtype or float32 only")
    if _on_cpu(q, k, v, q_pos, kv_pos):
        return flash_masked_fwd_reference(q, k, v, q_pos, kv_pos, block_q,
                                          block_k, out_dtype)
    B, Tq, Tk, H, D = _check("flash_masked_fwd", (q,), (k, v))
    _check_tma("flash_masked_fwd", q, k, v)
    qp, kp = _device_positions(q_pos, kv_pos, Tq, Tk, q.device)
    out = torch.empty(B, Tq, H, D, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    rc = _masked_lib().flash_masked_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qp), _ptr(kp),
        out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out), B, Tq, Tk, H,
        D, _scale(D), _DTYPE_CODES[q.dtype], int(out.dtype != q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _finish("mfwd", rc)
    return out, lse


def flash_masked_dq(q, k, v, do, lse, delta, q_pos=None, kv_pos=None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """B5: ``dq [B, Tq, H, D]`` in q's dtype."""
    if _on_cpu(q, k, v, do, lse, delta, q_pos, kv_pos):
        return flash_masked_dq_reference(q, k, v, do, lse, delta, q_pos,
                                         kv_pos, block_q, block_k)
    B, Tq, Tk, H, D = _check("flash_masked_dq", (q, do), (k, v), (lse, delta))
    _check_tma("flash_masked_dq", q, k, v, do)
    qp, kp = _device_positions(q_pos, kv_pos, Tq, Tk, q.device)
    dq = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    rc = _masked_lib().flash_masked_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(qp),
        _ptr(kp), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), B, Tq, Tk, H, D, _scale(D),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _finish("mdq", rc)
    return dq


def flash_masked_dkv(q, k, v, do, lse, delta, q_pos=None, kv_pos=None,
                     block_q: int = 64, block_k: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6: ``(dk, dv)``, each ``[B, Tk, H, D]`` in k's and v's dtype."""
    if _on_cpu(q, k, v, do, lse, delta, q_pos, kv_pos):
        return flash_masked_dkv_reference(q, k, v, do, lse, delta, q_pos,
                                          kv_pos, block_q, block_k)
    B, Tq, Tk, H, D = _check("flash_masked_dkv", (q, do), (k, v), (lse, delta))
    _check_tma("flash_masked_dkv", q, k, v, do)
    qp, kp = _device_positions(q_pos, kv_pos, Tq, Tk, q.device)
    dk = torch.empty(B, Tk, H, D, dtype=k.dtype, device=q.device)
    dv = torch.empty(B, Tk, H, D, dtype=v.dtype, device=q.device)
    rc = _masked_lib().flash_masked_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(qp),
        _ptr(kp), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv), B, Tq, Tk, H, D,
        _scale(D), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _finish("mdkv", rc)
    return dk, dv


def attention_delta(do, out) -> torch.Tensor:
    """``delta = rowsum(do * out)`` in fp32, ``[B, H, T]`` contiguous: the
    backward's plain op outside the kernels (``_bwd`` in the JAX package)."""
    return torch.einsum("bthd,bthd->bht", do.float(), out.float()).contiguous()


class _FlashMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, block_q, block_k):
        out, lse = flash_masked_fwd(q, k, v, q_pos, kv_pos, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.positions = (q_pos, kv_pos)
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = tma_ready(do)
        delta = attention_delta(do, out)
        args = (q, k, v, do, lse, delta, *ctx.positions, *ctx.blocks)
        dq = flash_masked_dq(*args)
        dk, dv = flash_masked_dkv(*args)
        return dq, dk, dv, None, None, None, None


# -------------------------------------------------------------------------
# public API
# -------------------------------------------------------------------------
def _positions(q, k, causal, q_pos, kv_pos):
    """Rectangular causal becomes ``arange`` positions; explicit positions
    pass through (they mask with or without ``causal``)."""
    if causal and q_pos is None:
        q_pos = torch.arange(q.shape[1], device=q.device)
        kv_pos = torch.arange(k.shape[1], device=k.device)
    return q_pos, kv_pos


def flash_attention(
    q, k, v, *,
    causal: bool = False,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
    block_q: int = 128,
    block_k: int = 128,
):
    """Flash attention over ``[B, T, H, D]``, differentiable.

    ``causal`` without positions masks by in-chunk index (the pruned CUDA
    path when Tq == Tk); explicit ``q_pos``/``kv_pos`` (int ``[Tq]``/``[Tk]``
    global positions) mask by keep = q_pos >= kv_pos. Returns
    ``[B, Tq, H, D]`` in q's dtype.
    """
    if causal and q_pos is None and q.shape[1] == k.shape[1]:
        return _FlashCausal.apply(q, k, v, block_q, block_k)
    q_pos, kv_pos = _positions(q, k, causal, q_pos, kv_pos)
    return _FlashMasked.apply(q, k, v, q_pos, kv_pos, block_q, block_k)


def flash_attention_with_lse(
    q, k, v, *,
    causal: bool = False,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
    block_q: int = 128,
    block_k: int = 128,
):
    """Forward-only variant returning ``(out, lse [B, H, Tq] fp32)``, the
    partial-result form ring attention merges across hops."""
    if causal and q_pos is None and q.shape[1] == k.shape[1]:
        return flash_causal_fwd(q, k, v, block_q, block_k)
    q_pos, kv_pos = _positions(q, k, causal, q_pos, kv_pos)
    return flash_masked_fwd(q, k, v, q_pos, kv_pos, block_q, block_k)
