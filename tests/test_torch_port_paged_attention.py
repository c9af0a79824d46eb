"""The port's attention ops against the JAX package's, on the CPU.

The port's plain decode version (``paged_decode_attention_reference``, what
its CUDA kernel is held against on the card) must match the JAX Pallas
kernel (interpret mode here, as tests/test_paging.py runs it) and the JAX
plain op; the port's plain prefill ops must write bit-identical pools and
attend to the same outputs. The CUDA kernel's own arithmetic (each chain
split across CTAs, one softmax pass per split, the partials merged by lse)
is copied here as a plain helper and held against the JAX kernel too, at
lengths around the split boundaries. Inputs come from numpy seeds and pass
to both frameworks as numpy arrays. Tolerance 2e-5: fp32 sums taken in
another order.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_distributed_tpu.ops import (
    cached_attention as jax_cached_attention,
    paged_cached_attention as jax_paged_cached_attention,
    paged_decode_attention as jax_paged_decode_attention,
)
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops import decode_attention as da
from pytorch_distributed_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, D, M = 4, 2, 8, 4
INACTIVE = 2  # all-zero table row, length 0


def _decode_case(page_size: int, seed: int):
    """Pools, block tables and query positions: ragged lengths, a chain with
    trash-page tail entries, an inactive slot, shuffled page ids."""
    rng = np.random.default_rng(seed)
    S = M * page_size
    n_pages = B * M + 1
    lengths = np.array([int(0.6 * S), page_size, 0, S - 1], np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((B, M), np.int32)
    for b in range(B):
        if b != INACTIVE:
            n = lengths[b] // page_size + 1
            tables[b, :n] = perm[b * M: b * M + n]
    pools = [rng.standard_normal((n_pages, page_size, H, D)).astype(np.float32)
             for _ in range(2)]
    new = [rng.standard_normal((B, 1, H, D)).astype(np.float32)
           for _ in range(3)]
    return pools, tables, lengths, new


def _t(a):
    return torch.from_numpy(np.array(a))


def _chain_case(page_size: int, n_entries: int, lengths, seed: int,
                trash_row=None):
    """q, pools and block tables for ``lengths`` (each query's position):
    every live row's chain holds the pages its length reaches, with page
    ids shuffled; ``trash_row`` is an inactive slot (all-zero table row,
    length 0)."""
    rng = np.random.default_rng(seed)
    n_b = len(lengths)
    n_pages = n_b * n_entries + 1
    lengths = np.asarray(lengths, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((n_b, n_entries), np.int32)
    for b in range(n_b):
        if b != trash_row:
            n = min(int(lengths[b]) // page_size + 1, n_entries)
            tables[b, :n] = perm[b * n_entries: b * n_entries + n]
    kp, vp = (rng.standard_normal((n_pages, page_size, H, D))
              .astype(np.float32) for _ in range(2))
    q = rng.standard_normal((n_b, 1, H, D)).astype(np.float32)
    return q, kp, vp, tables, lengths


def _split_merge(q, k_pages, v_pages, tables, lengths, per_split):
    """A plain copy of the CUDA kernel's arithmetic: each chain cut into
    splits of ``per_split`` table entries; per split one softmax pass (its
    max once, one exp per score); then the live partials (the splits that
    start at or before the query) merged by lse, each weighted by
    exp(m_i - M). An empty split (it starts past the query) writes nothing
    in the kernel; here it gets m = -1e30 and weight 0. fp32 throughout."""
    n_b, _, n_h, d = q.shape
    page = k_pages.shape[1]
    n_entries = tables.shape[1]
    span = per_split * page
    last = lengths.long().clamp(max=n_entries * page - 1)
    q32 = q[:, 0].float()
    parts = []
    for s0 in range(0, n_entries * page, span):
        pos = s0 + torch.arange(span)
        keep = (pos[None, :] <= last[:, None]) & (pos < n_entries * page)
        entry = (pos // page).clamp(max=n_entries - 1)
        pages = tables.long()[:, entry]                           # [B, span]
        k = k_pages[pages, pos % page].float()                    # [B, span, H, D]
        v = v_pages[pages, pos % page].float()
        sc = torch.einsum("bhd,bshd->bhs", q32, k) / d ** 0.5
        sc = torch.where(keep[:, None], sc, -torch.inf)
        live = (s0 <= last)[:, None]                              # [B, 1]
        m = torch.where(live, sc.amax(-1), -1e30)
        p = torch.exp(sc - m[..., None])
        parts.append((live, m, p.sum(-1),
                      torch.einsum("bhs,bshd->bhd", p, v)))
    m_all = torch.stack([m for _, m, _, _ in parts]).amax(0)
    out = torch.zeros(n_b, n_h, d)
    total = torch.zeros(n_b, n_h)
    for live, m, l, acc in parts:
        w = torch.where(live, torch.exp(m - m_all), 0.0)
        total = total + l * w
        out = out + acc * w[..., None]
    return (out / total[..., None])[:, None]


# (page size, table entries, pages per split, lengths): one split minus one
# position, exactly one split, one split plus one, two splits, length 0 of
# a live row, a chain that fills every table entry, and the trash row last
SPLIT_CASES = {
    "page4_split2": (4, 6, 2, [7, 8, 9, 16, 0, 23, 15, 0]),
    "page4_split1": (4, 6, 1, [3, 4, 5, 8, 0, 23, 11, 0]),
    "page16_default": (16, 12, pa.pages_per_split(16),
                       [63, 64, 65, 128, 0, 191, 127, 0]),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_merge_match_jax_kernel(case):
    """The CUDA kernel's split-and-merge arithmetic against the JAX Pallas
    decode kernel (interpret mode), fp32, within 2e-5."""
    page, n_entries, per_split, lengths = SPLIT_CASES[case]
    trash = len(lengths) - 1
    q, kp, vp, tables, lens = _chain_case(page, n_entries, lengths,
                                          seed=page + per_split,
                                          trash_row=trash)
    assert not tables[trash].any() and n_entries > per_split
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True)
    got = _split_merge(*[_t(a) for a in (q, kp, vp, tables, lens)], per_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_launch_argtypes_match_the_c_entry_point():
    """The ctypes binding against the source's C signature, argument by
    argument: pointers as c_void_p, ints, 64-bit strides, scale."""
    src = (_build._SRC_DIR / "paged_decode_attention.cu").read_text()
    args = re.search(r'extern "C" int paged_decode_attention_launch\(([^)]*)\)',
                     src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}
    want = []
    for arg in args.split(","):
        decl = " ".join(arg.replace("const ", "").split()[:-1])
        decl = decl.replace(" *", "*")
        want.append(kinds[decl])
    assert pa.LAUNCH_ARGTYPES == want


@pytest.mark.parametrize("page_size", [4, 16])
def test_decode_plain_version_matches_jax_kernel_and_plain_op(page_size):
    (kp, vp), tables, lengths, (q, kn, vn) = _decode_case(page_size, page_size)
    # the JAX plain op writes the new token's K/V and attends; the decode
    # kernels then read the written pools
    want, kp_w, vp_w = jax_paged_cached_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(lengths))
    jax_kernel = jax_paged_decode_attention(
        jnp.asarray(q), kp_w, vp_w, jnp.asarray(tables), jnp.asarray(lengths))

    k_pages, v_pages = _t(kp), _t(vp)
    pos = _t(lengths).long()[:, None]
    pa._scatter_new(k_pages, _t(kn), _t(tables), pos)
    pa._scatter_new(v_pages, _t(vn), _t(tables), pos)
    np.testing.assert_array_equal(k_pages.numpy(), np.asarray(kp_w))
    np.testing.assert_array_equal(v_pages.numpy(), np.asarray(vp_w))
    got = pa.paged_decode_attention_reference(
        _t(q), k_pages, v_pages, _t(tables), _t(lengths))
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_wrapper_takes_plain_version_only_on_cpu():
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other device never falls back to it."""
    (kp, vp), tables, lengths, (q, _, _) = _decode_case(4, 0)
    args = [_t(a) for a in (q, kp, vp, tables, lengths)]
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    assert pa.launches == before
    torch.testing.assert_close(
        got, pa.paged_decode_attention_reference(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention(*[a.to("meta") for a in args])
    assert pa.launches == before


def test_prefill_ops_match_jax_pools_bit_exact():
    """T > 1: a prefill, a window whose tail runs past the block table
    (routed to the trash page), then a decode step. Outputs at 2e-5, the
    updated pools and slotted caches bit-exact."""
    rng = np.random.default_rng(7)
    page_size, n_b = 4, 2
    S = M * page_size
    tables = np.array([[3, 7, 1, 5], [2, 8, 4, 6]], np.int32)
    kp = np.zeros((9, page_size, H, D), np.float32)
    vp = np.zeros_like(kp)
    kc = np.zeros((n_b, S, H, D), np.float32)
    vc = np.zeros_like(kc)
    jax_state = [jnp.asarray(a) for a in (kp, vp, kc, vc)]
    port_state = [_t(a) for a in (kp, vp, kc, vc)]
    # (T, offsets); the second window's last positions pass S in the paged
    # cache only (the slotted op is given positions inside the slot)
    windows = [(5, [0, 0]), (3, [S - 1, 9]), (1, [5, 12])]
    for T, off in windows:
        q, kn, vn = (rng.standard_normal((n_b, T, H, D)).astype(np.float32)
                     for _ in range(3))
        off = np.array(off, np.int32)
        want, jkp, jvp = jax_paged_cached_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jax_state[0], jax_state[1], jnp.asarray(tables), jnp.asarray(off))
        got, tkp, tvp = pa.paged_cached_attention(
            _t(q), _t(kn), _t(vn), port_state[0], port_state[1],
            _t(tables), _t(off))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
        np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
        jax_state[:2] = [jkp, jvp]

        soff = np.minimum(off, S - T).astype(np.int32)
        want, jkc, jvc = jax_cached_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jax_state[2], jax_state[3], jnp.asarray(soff))
        got, tkc, tvc = da.cached_attention(
            _t(q), _t(kn), _t(vn), port_state[2], port_state[3], _t(soff))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
        np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
        jax_state[2:] = [jkc, jvc]


# GPT-2 125M's serve lengths: prompts of 40-96 tokens plus up to 64 new
SERVE_LENGTHS = [40, 75, 103, 159, 96, 131, 52, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", ["ragged", "split_boundaries", "serve"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol, lengths):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if lengths == "ragged":
        (kp, vp), tables, lens, (q, _, _) = _decode_case(16, 3)
    else:
        page, n_entries, _, lens = SPLIT_CASES["page16_default"]
        if lengths == "serve":
            n_entries, lens = 64, SERVE_LENGTHS
        q, kp, vp, tables, lens = _chain_case(page, n_entries, lens, seed=5,
                                              trash_row=len(lens) - 1)
    args = [_t(q).to(dtype).cuda(), _t(kp).to(dtype).cuda(),
            _t(vp).to(dtype).cuda(), _t(tables).cuda(), _t(lens).cuda()]
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
