"""Paged attention over a block-table KV cache: plain torch ops + CUDA kernel.

Port of ``pytorch_distributed_tpu/ops/paged_attention.py``. K/V live in a
pool of fixed-size pages ``[n_pages, page_size, H, D]`` shared by every
sequence; each sequence owns an ordered chain of page ids in a block-table
row ``[max_pages]`` (table position ``m`` holds the page for global
positions ``m*page_size .. (m+1)*page_size - 1``).

* ``paged_cached_attention`` -- plain torch. Scatters the T new tokens
  through the block table, gathers the chain into a dense ``[B, S, H, D]``
  view and runs the slotted op's einsum/mask/softmax. It serves prefill
  (T > 1).
* ``paged_decode_attention`` -- the T = 1 decode step. A CUDA tensor goes
  to the hand-written kernels in ``csrc/paged_decode_attention.cu``, which
  read the pages through the table in place: each chain is split across
  CTAs of ``pages_per_split(...)`` pages, and the splits' partial softmax
  states are merged by lse in fp32 scratch the wrapper allocates. A CPU
  tensor goes to its plain version ``paged_decode_attention_reference``,
  which repeats the TPU kernel's arithmetic (fp32, ``-1e30`` mask,
  exact-zero weights on masked lanes, ``acc / l``).

Trash-page invariant: page 0 is never allocated. Inactive slots have an
all-zero table row, so their discarded writes land in page 0 and their
reads see page 0, masked by the ``position <= query`` rule.

Pools are updated in place: the scatter writes into the tensors it is given.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.decode_attention import attention_scale

__all__ = [
    "paged_cached_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "pages_per_split",
]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_SIZE = 256  # a row of D is read by at most 32 lanes, 8 values each
# cached positions one CTA of the decode kernel reads (whole pages)
SPLIT_POSITIONS = 64

# Kernel launches (not plain-version calls) since the counter was last set
# to 0: shows that a run went through the CUDA kernel.
launches = 0


def _scatter_new(
    pages: torch.Tensor,
    new: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
) -> torch.Tensor:
    """Write ``new [B, T, H, D]`` at global positions ``pos [B, T]`` through
    the block table, in place. Positions past the table (padded prefill
    tails) and zeroed table rows (inactive slots) route to page 0, the trash
    page, so out-of-range lanes can never alias a live page."""
    page_size = pages.shape[1]
    max_pages = block_tables.shape[1]
    pos = pos.long()
    m_raw = torch.div(pos, page_size, rounding_mode="floor")
    m = m_raw.clamp(0, max_pages - 1)
    page_id = torch.gather(block_tables.long(), 1, m)
    page_id = torch.where(m_raw < max_pages, page_id, 0)
    pages[page_id, pos % page_size] = new.to(pages.dtype)
    return pages


def paged_cached_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    position_offset: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write the new K/V through the block table, attend over the chain.

    Args:
      q, k_new, v_new: ``[B, T, H, D]`` projections for the T new tokens.
      k_pages, v_pages: ``[n_pages, page_size, H, D]`` page pools of one
        layer, updated in place.
      block_tables: ``[B, max_pages]`` int32 page ids per sequence.
      position_offset: ``[B]`` int32 global position of each sequence's
        first new token.

    Returns:
      ``(out [B, T, H, D], k_pages, v_pages)``.
    """
    B, T, H, D = q.shape
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    S = max_pages * page_size

    pos = position_offset.long()[:, None] + torch.arange(T, device=q.device)
    _scatter_new(k_pages, k_new, block_tables, pos)
    _scatter_new(v_pages, v_new, block_tables, pos)

    tables = block_tables.long()
    k_seq = k_pages[tables].reshape(B, S, H, D)
    v_seq = v_pages[tables].reshape(B, S, H, D)

    scale = attention_scale(D, q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", q, k_seq.to(q.dtype)) * scale
    visible = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = scores.masked_fill(
        ~visible[:, None], torch.finfo(scores.dtype).min
    )
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v_seq.to(q.dtype))
    return out, k_pages, v_pages


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the decode kernel: the TPU kernel's arithmetic,
    one table entry at a time with an online softmax across the chain."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"paged_decode_attention is decode-only (T=1), got T={T}")
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    scale = 1.0 / float(D) ** 0.5
    tables = block_tables.long()
    q_pos = lengths.long()                                   # [B]
    q32 = q[:, 0].float()                                    # [B, H, D]
    acc = torch.zeros(B, H, D, dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros(B, H, 1, dtype=torch.float32, device=q.device)
    offs = torch.arange(page_size, device=q.device)
    for m in range(max_pages):
        # pages whose first position is past the query add nothing
        live = (m * page_size <= q_pos)[:, None, None]      # [B, 1, 1]
        k = k_pages[tables[:, m]].float()                    # [B, page, H, D]
        v = v_pages[tables[:, m]].float()
        s = torch.einsum("bhd,bphd->bhp", q32, k) * scale    # [B, H, page]
        keep = ((m * page_size + offs)[None, :] <= q_pos[:, None])[:, None, :]
        s = torch.where(keep, s, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m_run - m_new)
        l_new = l_run * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhp,bphd->bhd", p, v)
        m_run = torch.where(live, m_new, m_run)
        l_run = torch.where(live, l_new, l_run)
        acc = torch.where(live, acc_new, acc)
    return (acc / l_run).to(q.dtype)[:, None]


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Decode-step attention reading K/V through the block table.

    The new token's K/V must already be scattered into the pools; the op
    only reads them.

    Args:
      q: ``[B, 1, H, D]`` decode queries.
      k_pages, v_pages: ``[n_pages, page_size, H, D]`` page pools.
      block_tables: ``[B, max_pages]`` int32 page ids.
      lengths: ``[B]`` int32, each query's global position: it attends
        positions ``<= lengths[b]``.

    Returns:
      ``out [B, 1, H, D]`` in q's dtype. CUDA tensors run the kernel (or
      raise); CPU tensors run the plain version.
    """
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_reference(*tensors)
    return _launch_kernel(*tensors)


def pages_per_split(page_size: int) -> int:
    """Table entries one CTA of the decode kernel reads: whole pages of
    about ``SPLIT_POSITIONS`` positions (at least one page)."""
    return max(1, SPLIT_POSITIONS // page_size)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# paged_decode_attention_launch of csrc/paged_decode_attention.cu: q, k, v,
# tables, lengths, out, workspace; B, H, D, page_size, max_pages,
# pages_per_split; the q and pool strides; scale, dtype, stream
LAUNCH_ARGTYPES = [_P] * 7 + [_I] * 6 + [_LL] * 8 + [ctypes.c_float, _I, _P]


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch_kernel(q, k_pages, v_pages, block_tables, lengths):
    global launches
    dev = q.device
    if dev.type != "cuda" or any(
        t.device != dev for t in (k_pages, v_pages, block_tables, lengths)
    ):
        raise ValueError(
            "paged_decode_attention: all tensors must be on one CUDA device "
            "(or all on the CPU for the plain version)"
        )
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            tuple(k_pages.shape[2:]) != (H, D):
        raise ValueError(
            f"pools must both be [P, page, {H}, {D}], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(
            f"q and pools must share one of {list(_DTYPE_CODES)}, got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    if D > _MAX_HEAD_SIZE:
        raise ValueError(f"head size {D} > {_MAX_HEAD_SIZE}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(
            f"block_tables must be [{B}, M] and lengths [{B}], got "
            f"{tuple(block_tables.shape)} and {tuple(lengths.shape)}"
        )
    if not (block_tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("block_tables and lengths must be contiguous")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError("q and the pools must be contiguous along D")
    page_size, max_pages = k_pages.shape[1], block_tables.shape[1]
    per_split = pages_per_split(page_size)
    splits = -(-max_pages // per_split)  # from shapes: lengths stay on the card
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    # each split's partial: acc [D], m, l
    workspace = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                            device=dev)
    rc = _kernel_lib().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), B, H, D, page_size, max_pages, per_split,
        q.stride(0), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed: cudaError {rc}"
        )
    launches += 1
    return out
