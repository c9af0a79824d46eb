"""Flash attention over ``[B, T, H, D]``: the CUDA causal kernels + plain ops.

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

The last two are the position-masked route (B4-B6 in the JAX package). Its
plain version runs here for CPU tensors; a CUDA tensor raises
``NotImplementedError`` until those kernels are ported (ROADMAP B4-B6).

Every kernel has a plain PyTorch version beside it (``*_reference``): the
same blocked online-softmax arithmetic in torch ops. A wrapper takes it only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``block_q``/``block_k`` tile the plain versions; the CUDA kernels' tiles
are fixed at 64 x 64.
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
]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_SIZE = 128  # the kernels stage D in shared memory as 64 or 128
_LIB = "flash_attention_causal"

# Kernel launches (not plain-version calls) since the counts were last set
# to 0, per kernel: shows that a run went through the CUDA kernels.
launches = {"fwd": 0, "dq": 0, "dkv": 0}


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
        rows = torch.arange(q0, q1, device=q.device)
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, q1 - q0), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, q1, block_k):
            k1 = min(k0 + block_k, T)
            kb = kt[:, :, k0:k1].float()
            vb = vt[:, :, k0:k1]
            cols = torch.arange(k0, k1, device=q.device)
            keep = rows[:, None] >= cols[None, :]
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


def _probs(qb, kb, lse_b, rows, cols, scale):
    """p recomputed from the saved lse, masked, with the dead-row guard."""
    keep = rows[:, None] >= cols[None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
    s = torch.where(keep, s, _NEG_INF)
    p = torch.where(keep, torch.exp(s - lse_b[..., None]), 0.0)
    return torch.where(lse_b[..., None] <= _NEG_INF / 2, 0.0, p)


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
        rows = torch.arange(q0, q1, device=q.device)
        acc = torch.zeros(B, H, q1 - q0, D, dtype=torch.float32, device=q.device)
        for k0 in range(0, q1, block_k):
            k1 = min(k0 + block_k, T)
            kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
            p = _probs(qb, kb, lse_b, rows, torch.arange(k0, k1, device=q.device),
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
        cols = torch.arange(k0, k1, device=q.device)
        dk_acc = torch.zeros(B, H, k1 - k0, D, dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range((k0 // block_q) * block_q, T, block_q):
            q1 = min(q0 + block_q, T)
            qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
            lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
            p = _probs(qb, kb, lse_b, torch.arange(q0, q1, device=q.device),
                       cols, scale)
            dv_acc = dv_acc + torch.einsum("bhqk,bhqd->bhkd", p, dob)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bhqk,bhqd->bhkd", ds, qb)
        dk[:, :, k0:k1] = dk_acc.to(k.dtype)
        dv[:, :, k0:k1] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2), dv.transpose(1, 2)


# -------------------------------------------------------------------------
# kernel wrappers: CPU tensors -> plain version, CUDA tensors -> B1/B2/B3
# -------------------------------------------------------------------------
def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    for name, n_ptrs in (("flash_causal_fwd_launch", 5),
                         ("flash_causal_dq_launch", 7),
                         ("flash_causal_dkv_launch", 8)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p] * n_ptrs + [strides, i, i, i, i, f, i, p]
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, q, k, v, *rest_bthd, stats=()):
    """Shape, dtype, device and layout checks for a kernel launch."""
    dev = q.device
    tensors = (q, k, v, *rest_bthd, *stats)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: all tensors must be on one CUDA device (or all on the "
            "CPU for the plain version)"
        )
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, T, H, D], got {tuple(q.shape)}")
    B, T, H, D = q.shape
    for t in (k, v, *rest_bthd):
        if tuple(t.shape) != (B, T, H, D):
            raise ValueError(
                f"{name}: every operand must be [B, T, H, D] = "
                f"{(B, T, H, D)} (causal self-attention, Tq == Tk), got "
                f"{tuple(t.shape)}"
            )
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in (k, v, *rest_bthd)):
        raise TypeError(
            f"{name}: q, k, v (and do) must share one of "
            f"{list(_DTYPE_CODES)}, got {[t.dtype for t in (q, k, v, *rest_bthd)]}"
        )
    if D > _MAX_HEAD_SIZE:
        raise ValueError(f"{name}: head size {D} > {_MAX_HEAD_SIZE}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *rest_bthd)):
        raise ValueError(f"{name}: operands must be contiguous along D")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T) or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: lse/delta must be contiguous fp32 [B, H, T] = "
                f"{(B, H, T)}, got {t.dtype} {tuple(t.shape)}"
            )
    return B, T, H, D


def _strides(*tensors):
    flat = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _finish(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"flash_causal_{name} kernel launch failed: "
                           f"cudaError {rc}")
    launches[name] += 1


def flash_causal_fwd(q, k, v, block_q: int = 64, block_k: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: ``(out [B, T, H, D] in q's dtype, lse [B, H, T] fp32)``."""
    if _on_cpu(q, k, v):
        return flash_causal_fwd_reference(q, k, v, block_q, block_k)
    B, T, H, D = _check("flash_causal_fwd", q, k, v)
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
    B, T, H, D = _check("flash_causal_dq", q, k, v, do, stats=(lse, delta))
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
    B, T, H, D = _check("flash_causal_dkv", q, k, v, do, stats=(lse, delta))
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
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = torch.einsum("bthd,bthd->bht", do.float(),
                             out.float()).contiguous()
        dq = flash_causal_dq(q, k, v, do, lse, delta, *ctx.blocks)
        dk, dv = flash_causal_dkv(q, k, v, do, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


# -------------------------------------------------------------------------
# the position-masked route (B4-B6 in the JAX package): plain version only
# -------------------------------------------------------------------------
def _masked_attention(q, k, v, q_pos, kv_pos):
    """Dense plain version of the position-masked flash kernels:
    ``(out, lse)``; keep = q_pos >= kv_pos when positions are given, else
    unmasked. Fully masked rows give out = 0 and lse = -1e30, as there.
    Differentiable through autograd."""
    tensors = (q, k, v) + tuple(t for t in (q_pos, kv_pos) if t is not None)
    if not _on_cpu(*tensors):
        raise NotImplementedError(
            "position-masked flash attention (explicit q_pos/kv_pos, "
            "rectangular causal, or causal=False) has no CUDA kernel yet: "
            "ROADMAP B4-B6"
        )
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(D)
    keep = None
    if q_pos is not None:
        keep = q_pos.reshape(-1)[:, None] >= kv_pos.reshape(-1)[None, :]
        s = torch.where(keep, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    safe = torch.clamp(l, min=1e-30)
    out = (acc / safe.transpose(1, 2)[..., None]).to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(safe), _NEG_INF)
    return out, lse


def _positions(q, k, causal, q_pos, kv_pos):
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
    return _masked_attention(q, k, v, q_pos, kv_pos)[0]


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
    return _masked_attention(q, k, v, q_pos, kv_pos)

