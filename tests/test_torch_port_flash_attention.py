"""The port's flash attention and chunked cross-entropy against the JAX ops.

On the CPU the port runs the plain versions of its kernels (B1-B3: the
pruned causal forward, dq and dk/dv); the JAX package runs its Pallas
kernels in interpret mode. Inputs are drawn with numpy and handed to both.
Tolerances (fp32, sums taken in another order and over other tiles, since
the JAX tiles follow ``_fit_block``): out and lse 1e-5, gradients 1e-4;
chunked cross-entropy loss and gradients 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.ops.chunked_xent import (
    chunked_cross_entropy as jax_chunked_xent,
)
from pytorch_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from pytorch_distributed_tpu_torch.ops.chunked_xent import chunked_cross_entropy

# the module (the package attribute of the same name is the function)
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")

torch.set_num_threads(2)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkvdo(B, Tq, Tk, H=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, **kw):
    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, interpret=True, **kw) * do)

    return jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _torch_grads(q, k, v, do, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    return tq.grad, tk.grad, tv.grad


def _assert_grads(jg, tg):
    for name, a, b in zip("qkv", jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("T", [64, 40])
@pytest.mark.parametrize("block", [16, 32])
def test_pruned_causal_matches_jax(T, block):
    """B1 (out, lse) and B2/B3 (dq, dk, dv) through the autograd.Function;
    T=40 is ragged for both tile sizes."""
    q, k, v, do = _qkvdo(2, T, T)
    kw = dict(causal=True, block_q=block, block_k=block)
    jo, jl = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           interpret=True, **kw)
    to, tl = fa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    _assert_grads(_jax_grads(q, k, v, do, **kw),
                  _torch_grads(q, k, v, do, **kw))


def test_kernel_entry_points_are_the_plain_versions_on_cpu():
    """The wrappers take the plain version for CPU tensors, and the
    backward pieces agree with autograd through the forward's plain ops."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkvdo(1, 40, 40, H=2, D=16))
    before = dict(fa.launches)
    out, lse = fa.flash_causal_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_causal_fwd_reference(q, k, v)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    delta = torch.einsum("bthd,bthd->bht", do, out)
    dq = fa.flash_causal_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_causal_dkv(q, k, v, do, lse, delta)
    assert fa.launches == before  # no kernel launched

    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / 4.0
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), tv)
    (ref * do).sum().backward()
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_rectangular_causal_uses_arange_positions():
    """Tq != Tk: causal becomes q_pos = arange(Tq), kv_pos = arange(Tk)."""
    q, k, v, do = _qkvdo(2, 24, 40, seed=1)
    kw = dict(causal=True, block_q=16, block_k=16)
    jo, jl = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           interpret=True, **kw)
    to, tl = fa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    _assert_grads(_jax_grads(q, k, v, do, **kw),
                  _torch_grads(q, k, v, do, **kw))


def test_explicit_positions_always_mask():
    """Explicit positions mask with or without ``causal``; rows that see
    nothing give out = 0 and lse = -1e30, and no gradient."""
    q, k, v, do = _qkvdo(2, 16, 24, seed=2)
    rng = np.random.default_rng(3)
    q_pos = rng.permutation(np.arange(10, 42, 2))[:16].astype(np.int32)
    q_pos[0] = 3  # below every kv position: a fully masked row
    kv_pos = rng.permutation(np.arange(8, 32)).astype(np.int32)
    for causal in (False, True):
        kw = dict(causal=causal, block_q=8, block_k=8)
        jo, jl = jax_flash_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
            interpret=True, **kw)
        tpos = dict(q_pos=torch.from_numpy(q_pos),
                    kv_pos=torch.from_numpy(kv_pos))
        to, tl = fa.flash_attention_with_lse(
            *(torch.from_numpy(x) for x in (q, k, v)), **tpos, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
        assert np.all(to.numpy()[:, 0] == 0) and np.all(tl.numpy()[:, :, 0] == -1e30)
        jg = _jax_grads(q, k, v, do, q_pos=jnp.asarray(q_pos),
                        kv_pos=jnp.asarray(kv_pos), **kw)
        _assert_grads(jg, _torch_grads(q, k, v, do, **tpos, **kw))


def test_non_causal_is_unmasked():
    q, k, v, do = _qkvdo(2, 24, 40, seed=4)
    kw = dict(causal=False, block_q=8, block_k=8)
    jo = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, **kw)
    to = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    _assert_grads(_jax_grads(q, k, v, do, **kw),
                  _torch_grads(q, k, v, do, **kw))


def test_off_cpu_tensors_never_take_a_plain_version():
    """A tensor off the CPU launches a kernel or raises: on a device that is
    neither the CPU nor CUDA, every route (the pruned causal one, and the
    position-masked one for non-causal, rectangular causal and explicit
    positions) refuses it instead of taking a plain version."""
    q = torch.empty(1, 8, 2, 16, device="meta")
    pos = torch.arange(8, device="meta")
    before = dict(fa.launches)
    for call in (lambda: fa.flash_attention(q, q, q, causal=False),
                 lambda: fa.flash_attention_with_lse(q, q[:, :4], q[:, :4],
                                                     causal=True),
                 lambda: fa.flash_attention(q, q, q, causal=True, q_pos=pos,
                                            kv_pos=pos),
                 lambda: fa.flash_attention(q, q, q, causal=True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert fa.launches == before


@pytest.mark.parametrize("dtype", [np.float32])
def test_chunked_cross_entropy_matches_jax(dtype):
    """Loss and both gradients of the vocab-chunked CE, with a vocab that
    the chunks do not divide (97 = 7 x 13 + 6)."""
    rng = np.random.default_rng(5)
    N, C, V, n_chunks = 24, 16, 97, 8
    x = rng.standard_normal((N, C)).astype(dtype)
    W = (0.3 * rng.standard_normal((V, C))).astype(dtype)
    y = rng.integers(0, V, N).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)

    jl = jax_chunked_xent(jnp.asarray(x), jnp.asarray(W), jnp.asarray(y), n_chunks)
    jdx, jdW = jax.grad(
        lambda x, W: jnp.sum(jax_chunked_xent(x, W, jnp.asarray(y), n_chunks) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))

    tx = torch.from_numpy(x).requires_grad_()
    tW = torch.from_numpy(W).requires_grad_()
    tl = chunked_cross_entropy(tx, tW, torch.from_numpy(y), n_chunks)
    (tl * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **tol)
    np.testing.assert_allclose(tW.grad.numpy(), np.asarray(jdW), **tol)
    # and the dense CE it replaces
    dense = torch.nn.functional.cross_entropy(
        torch.from_numpy(x) @ torch.from_numpy(W).t(),
        torch.from_numpy(y).long(), reduction="none")
    np.testing.assert_allclose(tl.detach().numpy(), dense.numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """B1-B3 on the card against their plain versions, on the strided
    q/k/v views of a fused qkv projection and a ragged T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    B, T, H, D = 2, 200, 3, 64
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(dtype).cuda()
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g).to(dtype).cuda()
    out, lse = fa.flash_causal_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_causal_fwd_reference(q, k, v)
    delta = torch.einsum("bthd,bthd->bht", do.float(),
                         ref_out.float()).contiguous()
    got = [out, lse, fa.flash_causal_dq(q, k, v, do, ref_lse, delta),
           *fa.flash_causal_dkv(q, k, v, do, ref_lse, delta)]
    want = [ref_out, ref_lse,
            fa.flash_causal_dq_reference(q, k, v, do, ref_lse, delta),
            *fa.flash_causal_dkv_reference(q, k, v, do, ref_lse, delta)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
