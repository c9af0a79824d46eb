"""Context parallelism: ring attention and Ulysses over ``torch.distributed``.

Port of ``pytorch_distributed_tpu/parallel/context_parallel.py``. The
sequence is split over the ranks of a mesh axis inside the attention:

* **ring attention**: each rank holds one chunk of Q, K and V; K/V chunks
  travel one hop around the ring per step (``comm.p2p``: a send to
  rank + 1 and a receive from rank - 1 on the axis's group, through host
  memory for a card tensor on gloo; at a group size of 1 the
  rotation is the identity and no P2P op is issued). ``impl="flash"`` (the
  default) runs each hop through the position-masked flash kernels
  (B4-B6, ``ops.flash_attention``) with the hop's global positions and
  merges the per-hop ``(out fp32, lse)`` partials with ``logaddexp``; its
  backward (``_RingFlash``) rotates K/V again, with the dK/dV accumulators
  travelling beside their chunk and home after n hops. ``impl="einsum"``
  is the oracle: materialised scores, differentiated by autograd through
  ``_Rotate``;
* **Ulysses**: two all-to-alls swap the split from the sequence to the
  heads and back; each rank attends the whole sequence on H/n heads;
* **zigzag**: ``zigzag_reorder`` gives rank r the chunks r and 2n-1-r, so
  causal work is balanced; the ring then masks by zigzag positions.

The interface is global, as the JAX package's ``shard_map`` wrapper:
``make_ring_attention(mesh, ...)`` returns ``attn(q, k, v, causal)`` over
the ``[B, T, H, D]`` tensors every rank holds whole. It takes the rank's
chunk, runs the ring and all-gathers the chunks along T; its backward
slices the gradient, runs the ring backward and all-gathers dq, dk, dv. So
it plugs into ``GPT2Config.attn_impl`` with the model unchanged, and the
gradients come out the same on every rank.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from pytorch_distributed_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_masked_dkv,
    flash_masked_dq,
    flash_masked_fwd,
    tma_ready,
)
from pytorch_distributed_tpu_torch.parallel import comm

__all__ = [
    "ring_attention",
    "make_ring_attention",
    "ulysses_attention",
    "make_ulysses_attention",
    "zigzag_reorder",
    "zigzag_restore",
]

_NEG_INF = -1e30


# -- collectives on an axis's group ----------------------------------------
def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank r + step of ``group`` and return the tensor that
    rank r - step sent (ranks modulo the group size), through
    ``comm.p2p`` (counted). gloo sends host memory only: on a gloo group a
    card tensor goes through a host copy each way."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = x.to("cpu") if staged else x.contiguous()
    out = torch.empty_like(src)
    comm.p2p(group, sends=[(src, (r + step) % n)],
             recvs=[(out, (r - step) % n)])
    return out.to(x.device) if staged else out


class _Rotate(torch.autograd.Function):
    """One ring hop (``lax.ppermute`` to rank + 1); the gradient travels
    back to rank - 1."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's chunk, concatenated along T in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _chunk(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[1] % n:
        raise ValueError(f"sequence of {x.shape[1]} does not split into {n} "
                         "chunks")
    t = x.shape[1] // n
    return x.narrow(1, dist.get_rank(group) * t, t)


class _ShardSeq(torch.autograd.Function):
    """The rank's chunk of a global ``[B, T, ...]`` tensor (``shard_map``'s
    in_specs); the backward all-gathers the chunk's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """All chunks along T (``shard_map``'s out_specs); the backward keeps
    the rank's chunk of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group), None


def _shard_seq(x, group):
    if dist.get_world_size(group) == 1:
        return x
    return _ShardSeq.apply(x, group)


def _unshard_seq(x, group):
    if dist.get_world_size(group) == 1:
        return x
    return _GatherSeq.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; chunk j of the result came from
    rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` is its own adjoint: the gradient goes back the same
    way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


# -- ring attention, the einsum oracle -------------------------------------
def _block_attn(q, k, v, mask):
    """One Q-chunk x KV-chunk partial attention: (unnormalised out
    ``[B, Tq, H, D]`` fp32, row max ``m`` and sum ``den`` ``[B, H, Tq, 1]``)
    for the online-softmax merge; ``mask`` ``[Tq, Tk]`` bool or None."""
    D = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(D)))
    s = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF / 2)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    return out, m, den


def _merge(acc_out, acc_m, acc_den, out, m, den):
    """Online-softmax combine of two partial results (``_SDPAMerger``)."""
    new_m = torch.maximum(acc_m, m)
    a = torch.exp(acc_m - new_m)
    b = torch.exp(m - new_m)
    new_den = acc_den * a + den * b
    # out is [B, T, H, D]; m and den are [B, H, T, 1]
    new_out = acc_out * a.transpose(1, 2) + out * b.transpose(1, 2)
    return new_out, new_m, new_den


def _chunk_positions(owner: int, n: int, T: int, zigzag: bool, device):
    """Global positions ``[T]`` (int32) of the chunk ``owner`` holds."""
    if not zigzag:
        return owner * T + torch.arange(T, dtype=torch.int32, device=device)
    half = T // 2
    idx = torch.arange(half, dtype=torch.int32, device=device)
    return torch.cat([owner * half + idx, (2 * n - 1 - owner) * half + idx])


def ring_attention(q, k, v, *, group, causal: bool = True,
                   zigzag: bool = False):
    """Ring attention over ``group`` on this rank's chunks ``[B, T_local,
    H, D]`` (the einsum oracle). Each of the n steps attends the local Q
    to the K/V chunk held, then rotates K/V one hop. Causal masking uses
    global chunk positions (zigzag ones with ``zigzag``). Returns
    ``[B, T_local, H, D]`` in q's dtype; differentiable."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, T, H, D = q.shape
    q_pos = _chunk_positions(idx, n, T, zigzag, q.device)
    acc_out = torch.zeros(B, T, H, D, dtype=torch.float32, device=q.device)
    acc_m = torch.full((B, H, T, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    acc_den = torch.zeros(B, H, T, 1, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for hop in range(n):
        mask = None
        if causal:
            kv_pos = _chunk_positions((idx - hop) % n, n, T, zigzag, q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
        acc_out, acc_m, acc_den = _merge(acc_out, acc_m, acc_den,
                                         *_block_attn(q, k_cur, v_cur, mask))
        if hop < n - 1:
            k_cur, v_cur = _Rotate.apply(k_cur, group), _Rotate.apply(v_cur, group)
    out = acc_out / torch.clamp(acc_den.transpose(1, 2), min=1e-20)
    return out.to(q.dtype)


# -- ring attention over the flash kernels ---------------------------------
# One rank's side of one hop, apart from the K/V rotation: ``_RingFlash``
# runs them with the rotation over the group, and a single process can run
# them for every rank of a ring with the rotation as a list rotation.
def _hop_positions(causal, zigzag, idx, n, hop, T, device):
    """(q_pos, kv_pos) of rank ``idx``'s hop ``hop`` (Nones: not causal)."""
    if not causal:
        return None, None
    return (_chunk_positions(idx, n, T, zigzag, device),
            _chunk_positions((idx - hop) % n, n, T, zigzag, device))


def _hop_forward(q, k_cur, v_cur, idx, n, hop, causal, zigzag,
                 block_q=128, block_k=128):
    """B4 on the K/V chunk held at ``hop``: the fp32 partial (out, lse)."""
    pos = _hop_positions(causal, zigzag, idx, n, hop, q.shape[1], q.device)
    return flash_masked_fwd(q, k_cur, v_cur, *pos, block_q, block_k,
                            out_dtype=torch.float32)


def _merge_partial(acc, part):
    """``(out, lse)`` of two fp32 partials merged with ``logaddexp``
    (``_merge_lse``); ``acc`` None is the first hop's."""
    if acc is None:
        return part
    (out_acc, lse_acc), (out_h, lse_h) = acc, part
    new_lse = torch.logaddexp(lse_acc, lse_h)              # [B, H, T]
    w_old = torch.exp(lse_acc - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_h - new_lse).transpose(1, 2)[..., None]
    return out_acc * w_old + out_h * w_new, new_lse


def _hop_backward(q, k_cur, v_cur, do, lse, delta, idx, n, hop, causal,
                  zigzag, block_q=128, block_k=128):
    """B5 and B6 on the K/V chunk held at ``hop``, with the ring's final
    lse and delta and K/V cast to q's dtype: fp32 (dq, dk, dv) of the hop."""
    pos = _hop_positions(causal, zigzag, idx, n, hop, q.shape[1], q.device)
    args = (q, k_cur.to(q.dtype), v_cur.to(q.dtype), do, lse, delta, *pos,
            block_q, block_k)
    dk, dv = flash_masked_dkv(*args)
    return flash_masked_dq(*args).float(), dk.float(), dv.float()


class _RingFlash(torch.autograd.Function):
    """Ring attention with B4-B6 as the local op (``_ring_flash_fn``): the
    forward merges each hop's fp32 ``(out, lse)``; the backward calls B5
    and B6 per hop with the final out and lse, accumulating dq, dk and dv
    in fp32, dK/dV travelling with their chunk."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, zigzag, block_q, block_k):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        spec = (causal, zigzag, block_q, block_k)
        acc, k_cur, v_cur = None, k, v
        for hop in range(n):
            acc = _merge_partial(acc, _hop_forward(q, k_cur, v_cur, idx, n,
                                                   hop, *spec))
            if hop < n - 1:
                k_cur, v_cur = _shift(k_cur, group, 1), _shift(v_cur, group, 1)
        out = acc[0].to(q.dtype)
        ctx.save_for_backward(q, k, v, out, acc[1])
        ctx.group, ctx.spec = group, spec
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        do = tma_ready(do)
        delta = attention_delta(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for hop in range(n):
            dq_h, dk_h, dv_h = _hop_backward(q, k_cur, v_cur, do, lse, delta,
                                             idx, n, hop, *ctx.spec)
            dq += dq_h
            dk += dk_h
            dv += dv_h
            if hop < n - 1:
                k_cur, v_cur = _shift(k_cur, group, 1), _shift(v_cur, group, 1)
            # after n rotations every dK/dV accumulator is home
            dk, dv = _shift(dk, group, 1), _shift(dv, group, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def make_ring_attention(
    mesh,
    axis: str = "cp",
    *,
    causal: bool = True,
    zigzag: bool = False,
    remat: bool = True,
    impl: str = "flash",
    block_q: int = 128,
    block_k: int = 128,
):
    """``attn_impl(q, k, v, causal=...)`` over the GLOBAL ``[B, T, H, D]``
    tensors: the sequence is split over ``mesh``'s ``axis`` and ring
    attention runs on each rank's chunk. Plug into ``GPT2Config.attn_impl``.

    ``impl="flash"`` (default) runs each hop through B4-B6; ``"einsum"``
    is the oracle, which materialises each hop's scores (recomputed in the
    backward with ``remat``). ``block_q``/``block_k`` tile the flash
    kernels' plain versions (the CPU route); with ``zigzag`` the caller
    hands in ``zigzag_reorder``-ed tensors.
    """
    if impl not in ("flash", "einsum"):
        raise ValueError(f"impl {impl!r}: 'flash' or 'einsum'")
    group = mesh.get_group(axis)

    def attn(q, k, v, causal: bool = causal):
        ql, kl, vl = (_shard_seq(x, group) for x in (q, k, v))
        if impl == "flash":
            out = _RingFlash.apply(ql, kl, vl, group, causal, zigzag, block_q,
                                   block_k)
        else:
            fn = functools.partial(ring_attention, group=group, causal=causal,
                                   zigzag=zigzag)
            if remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(fn, ql, kl, vl,
                                                        use_reentrant=False)
            else:
                out = fn(ql, kl, vl)
        return _unshard_seq(out, group)

    return attn


# -- Ulysses (head-wise all-to-all) ----------------------------------------
def ulysses_attention(q, k, v, *, group, causal: bool = True,
                      impl: str = "einsum", block_q: int = 128,
                      block_k: int = 128):
    """DeepSpeed-Ulysses sequence parallelism on this rank's chunks
    ``[B, T_local, H, D]``: an all-to-all swaps the split from the sequence
    to the heads, each rank attends the whole sequence on H/n heads, and a
    second all-to-all swaps back. Needs ``H % n == 0``. ``impl="flash"``
    runs the local attention through ``ops.flash_attention`` (B1-B3 when
    causal, B4-B6 otherwise)."""
    n = dist.get_world_size(group)
    B, Tl, H, D = q.shape
    if H % n:
        raise ValueError(f"ulysses: heads {H} not divisible by axis size {n}")

    def seq_to_heads(x):  # [B, T/n, H, D] -> [B, T, H/n, D]
        if n == 1:
            return x
        y = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
        y = _AllToAll.apply(y, group)          # [source rank, B, Tl, H/n, D]
        return y.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)

    def heads_to_seq(x):  # [B, T, H/n, D] -> [B, T/n, H, D]
        if n == 1:
            return x
        y = x.reshape(B, n, Tl, H // n, D).permute(1, 0, 2, 3, 4)
        y = _AllToAll.apply(y, group)          # [head group, B, Tl, H/n, D]
        return y.permute(1, 2, 0, 3, 4).reshape(B, Tl, H, D)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if impl == "flash":
        outh = flash_attention(qh, kh, vh, causal=causal, block_q=block_q,
                               block_k=block_k)
    else:
        T = qh.shape[1]
        mask = (torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
                if causal else None)
        out, _, den = _block_attn(qh, kh, vh, mask)
        outh = (out / torch.clamp(den.transpose(1, 2), min=1e-20)).to(q.dtype)
    return heads_to_seq(outh)


def make_ulysses_attention(
    mesh,
    axis: str = "cp",
    *,
    causal: bool = True,
    impl: str = "flash",
    block_q: int = 128,
    block_k: int = 128,
):
    """Global-tensor wrapper for :func:`ulysses_attention` (see
    :func:`make_ring_attention`)."""
    if impl not in ("flash", "einsum"):
        raise ValueError(f"impl {impl!r}: 'flash' or 'einsum'")
    group = mesh.get_group(axis)

    def attn(q, k, v, causal: bool = causal):
        ql, kl, vl = (_shard_seq(x, group) for x in (q, k, v))
        out = ulysses_attention(ql, kl, vl, group=group, causal=causal,
                                impl=impl, block_q=block_q, block_k=block_k)
        return _unshard_seq(out, group)

    return attn


# -- causal load balancing (zigzag) ----------------------------------------
def _zigzag_order(n_shards: int):
    order = []
    for r in range(n_shards):
        order += [r, 2 * n_shards - 1 - r]
    return order


def zigzag_reorder(x: torch.Tensor, n_shards: int, seq_dim: int = 1):
    """Reorder the GLOBAL sequence so shard r gets chunks (r, 2n-1-r) (torch
    ``_load_balancer.py``'s role). Apply before sharding; undo with
    :func:`zigzag_restore`."""
    T = x.shape[seq_dim]
    if T % (2 * n_shards):
        raise ValueError(f"seq len {T} not divisible by 2*{n_shards}")
    chunks = torch.chunk(x, 2 * n_shards, dim=seq_dim)
    return torch.cat([chunks[i] for i in _zigzag_order(n_shards)], dim=seq_dim)


def zigzag_restore(x: torch.Tensor, n_shards: int, seq_dim: int = 1):
    """Inverse of :func:`zigzag_reorder`."""
    inv = [0] * (2 * n_shards)
    for pos, src in enumerate(_zigzag_order(n_shards)):
        inv[src] = pos
    chunks = torch.chunk(x, 2 * n_shards, dim=seq_dim)
    return torch.cat([chunks[i] for i in inv], dim=seq_dim)
