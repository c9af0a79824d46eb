"""The port's attention ops against the JAX package's, on the CPU.

The port's plain decode version (``paged_decode_attention_reference``, what
its CUDA kernel is held against on the card) must match the JAX Pallas
kernel (interpret mode here, as tests/test_paging.py runs it) and the JAX
plain op; the port's plain prefill ops must write bit-identical pools and
attend to the same outputs. Inputs come from numpy seeds and pass to both
frameworks as numpy arrays. Tolerance 2e-5: fp32 sums taken in another
order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_distributed_tpu.ops import (
    cached_attention as jax_cached_attention,
    paged_cached_attention as jax_paged_cached_attention,
    paged_decode_attention as jax_paged_decode_attention,
)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (kp, vp), tables, lengths, (q, _, _) = _decode_case(16, 3)
    args = [_t(q).to(dtype).cuda(), _t(kp).to(dtype).cuda(),
            _t(vp).to(dtype).cuda(), _t(tables).cuda(), _t(lengths).cuda()]
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
