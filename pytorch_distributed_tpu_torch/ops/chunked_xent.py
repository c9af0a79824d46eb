"""Vocab-chunked softmax cross-entropy: the LM loss without the logits.

Port of ``pytorch_distributed_tpu/ops/chunked_xent.py`` (a ``lax.scan``
there, not a Pallas kernel, so plain torch ops are a faithful port).
``loss_i = logsumexp_v(x_i . W_v) - x_i . W_{y_i}`` from hidden states
``x [N, C]`` and the tied head ``W [V, C]``:

* forward: a loop over vocab chunks with an online (running-max)
  logsumexp; the extra memory is one ``[N, ceil(V / n_chunks)]`` chunk of
  fp32 logits at a time;
* backward (``autograd.Function``): the chunks again, each chunk's logits
  and softmax recomputed from the saved ``lse``; the saved tensors are
  ``x``, ``W``, ``targets`` and ``lse [N]``, nothing of size N x V.
  dx = sum_v p_v W_v - W_y,  dW_v = sum_i p_iv x_i - sum_{i: y_i = v} x_i.

Products take the inputs' values (bf16 in a bf16 model) and accumulate in
fp32, as the JAX op's ``preferred_element_type=float32`` does; p * g is
rounded to x's dtype before the backward products, as there. All three
products go through ``matmul_f32``.
"""

from __future__ import annotations

import torch

from pytorch_distributed_tpu_torch.observability import spans

__all__ = ["chunked_cross_entropy", "matmul_f32"]

_HALF = (torch.bfloat16, torch.float16)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` in the operands' promoted dtype, accumulated
    and returned in fp32: JAX's ``dot_general(...,
    preferred_element_type=float32)``. 16-bit operands on CUDA take one
    tensor-core GEMM (``aten::mm.dtype``); on the CPU, whose build lacks
    that overload, the operands are widened to fp32, which gives the same
    values up to the summation order. Not differentiable: callers wrap it
    in an ``autograd.Function``."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    if a.is_cuda and dtype in _HALF:
        return torch.mm(a.to(dtype), b.to(dtype), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunks(V: int, n_chunks: int):
    chunk = -(-V // n_chunks)
    return [(i * chunk, min((i + 1) * chunk, V)) for i in range(n_chunks)
            if i * chunk < V]


def _logits(x, W, v0, v1):
    return matmul_f32(x, W[v0:v1].t())


def _forward(x, W, targets, n_chunks):
    N = x.shape[0]
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros(N, dtype=torch.float32, device=x.device)
    for v0, v1 in _chunks(W.shape[0], n_chunks):
        logits = _logits(x, W, v0, v1)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
    lse = m + torch.log(s)
    tgt = (x.float() * W[targets].float()).sum(-1)
    return lse - tgt, lse


class _ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W, targets, n_chunks):
        loss, lse = _forward(x, W, targets, n_chunks)
        ctx.save_for_backward(x, W, targets, lse)
        ctx.n_chunks = n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, W, targets, lse = ctx.saved_tensors
        g = g.float()
        x32 = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dW = torch.empty(W.shape, dtype=torch.float32, device=x.device)
        for v0, v1 in _chunks(W.shape[0], ctx.n_chunks):
            p = torch.exp(_logits(x, W, v0, v1) - lse[:, None])
            pg = (p * g[:, None]).to(x.dtype)
            dx = dx + matmul_f32(pg, W[v0:v1])
            dW[v0:v1] = matmul_f32(pg.t(), x)
        # target terms: dx -= g W[y];  dW[y] -= g x (scatter-add)
        dx = dx - g[:, None] * W[targets].float()
        dW.index_add_(0, targets, -g[:, None] * x32)
        return dx.to(x.dtype), dW.to(W.dtype), None, None


def chunked_cross_entropy(x: torch.Tensor, W: torch.Tensor,
                          targets: torch.Tensor, n_chunks: int = 8
                          ) -> torch.Tensor:
    """Per-token cross-entropy ``[N]`` (fp32) of hidden states ``x [N, C]``
    against a tied head ``W [V, C]`` and int labels ``targets [N]`` in
    ``[0, V)``, computed ``n_chunks`` vocab chunks at a time. The span
    ``lm_head`` (``observability.spans``) bounds it: it applies the head
    itself."""
    x, W = spans.enter("lm_head", x, W)
    loss = _ChunkedCrossEntropy.apply(x, W, targets.long(), n_chunks)
    return spans.leave("lm_head", loss)
