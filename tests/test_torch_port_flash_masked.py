"""The port's position-masked flash kernels (B4-B6) against the JAX package.

On the CPU ``flash_masked_fwd``/``_dq``/``_dkv`` run their plain versions
(the kernels' blocked arithmetic in torch ops); the JAX package runs its
Pallas kernels (``_fwd``, ``_bwd``) in interpret mode. Inputs are drawn
with numpy and handed to both. The cases are the position patterns a ring
hop gives the kernels: the diagonal hop, hops 0 and 1 of every rank of a
4-rank zigzag ring, a hop that holds only future keys (every row dead), no positions,
a rectangular hop, a ragged T against JAX's shrunk tiles, and bf16 inputs
with fp32 partial outputs.

Tolerances: fp32 1e-5 (sums in another order, over other tiles); bf16
``2e-2 x (1 + |ref|)`` (outputs rounded once from fp32, p rounded to bf16
before PV in both, so a bf16 ulp of 2^-8 of the value).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfa = importlib.import_module("pytorch_distributed_tpu.ops.flash_attention")
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2e-2
H, D = 2, 32


def _zigzag(owner, n, T):
    half = T // 2
    return np.concatenate([owner * half + np.arange(half),
                           (2 * n - 1 - owner) * half + np.arange(half)])


def _draw(B, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_run(q, k, v, do, q_pos, kv_pos, block, dtype, out_dtype=None):
    """JAX ``_fwd`` (out, lse) and ``_bwd`` (dq, dk, dv) in interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    jp = [None if p is None else jnp.asarray(p, jnp.int32)
          for p in (q_pos, kv_pos)]
    kw = dict(block_q=block, block_k=block, interpret=True)
    out, lse = jfa._fwd(jq, jk, jv, *jp, out_dtype=out_dtype, **kw)
    # the backward takes the forward's out in q's dtype, as _flash saves it
    out_q = out if out_dtype is None else jfa._fwd(jq, jk, jv, *jp, **kw)[0]
    grads = jfa._bwd(jq, jk, jv, *jp, out_q, lse, jdo, **kw)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, lse, *grads)]


def _port_run(q, k, v, do, q_pos, kv_pos, block, dtype, out_dtype=None):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    tp = [None if p is None else torch.from_numpy(np.asarray(p, np.int32))
          for p in (q_pos, kv_pos)]
    out, lse = fa.flash_masked_fwd(tq, tk, tv, *tp, block, block,
                                   out_dtype=out_dtype)
    out_q = out if out_dtype is None else \
        fa.flash_masked_fwd(tq, tk, tv, *tp, block, block)[0]
    delta = fa.attention_delta(tdo, out_q)
    args = (tq, tk, tv, tdo, lse, delta, *tp, block, block)
    dq = fa.flash_masked_dq(*args)
    dk, dv = fa.flash_masked_dkv(*args)
    return [x.float().numpy() for x in (out, lse, dq, dk, dv)]


def _assert_match(got, want, tol, names=("out", "lse", "dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        if isinstance(tol, float):
            err = np.abs(a - b)
            assert np.all(err <= tol * (1 + np.abs(b))), \
                f"{name}: max err {err.max()}"
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=name)


N, TL = 4, 24   # the ring: 4 ranks, 24 positions a chunk (zigzag halves of 12)
CASES = {
    # name: (Tq, Tk, q_pos, kv_pos, block)
    "diagonal": (TL, TL, np.arange(TL), np.arange(TL), 16),
    "past_hop": (TL, TL, TL + np.arange(TL), np.arange(TL), 16),
    "no_positions": (TL, TL, None, None, 16),
    "rectangular": (16, 48, 32 + np.arange(16), np.arange(48), 16),
    "ragged_T40": (40, 40, np.arange(40), np.arange(40), 16),
    **{f"zigzag_rank{r}_hop{h}": (TL, TL, _zigzag(r, N, TL),
                                  _zigzag((r - h) % N, N, TL), 16)
       for r in range(N) for h in (0, 1)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_kernels_match_jax(case):
    """Out, lse, dq, dk and dv of B4-B6's plain versions against JAX's
    Pallas kernels in fp32. ``block`` 16 tiles a zigzag chunk across the
    jump between its two runs, and T=40 is ragged for it (JAX shrinks its
    tiles to 8)."""
    Tq, Tk, q_pos, kv_pos, block = CASES[case]
    x = _draw(2, Tq, Tk, seed=sorted(CASES).index(case))
    _assert_match(_port_run(*x, q_pos, kv_pos, block, torch.float32),
                  _jax_run(*x, q_pos, kv_pos, block, jnp.float32), TOL)


def test_all_future_hop_is_dead():
    """A hop that holds only future keys (rank 0, hop 1 of a plain ring):
    out exactly 0, lse -1e30 and exact zero gradients, in both packages;
    the fp32 ring merge then leaves its accumulator as it was."""
    q_pos, kv_pos = np.arange(TL), TL + np.arange(TL)
    x = _draw(2, TL, TL, seed=7)
    got = _port_run(*x, q_pos, kv_pos, 16, torch.float32)
    want = _jax_run(*x, q_pos, kv_pos, 16, jnp.float32)
    _assert_match(got, want, TOL)
    out, lse, dq, dk, dv = got
    assert not out.any() and np.all(lse == -1e30)
    assert not dq.any() and not dk.any() and not dv.any()
    acc = np.random.default_rng(8).standard_normal(out.shape).astype(np.float32)
    acc_lse = np.random.default_rng(9).standard_normal(lse.shape).astype(np.float32)
    t_lse, t_acc = torch.from_numpy(acc_lse), torch.from_numpy(acc)
    new = torch.logaddexp(t_lse, torch.from_numpy(lse))
    merged = (t_acc * torch.exp(t_lse - new).transpose(1, 2)[..., None]
              + torch.from_numpy(out) * torch.exp(torch.from_numpy(lse) - new)
              .transpose(1, 2)[..., None])
    assert torch.equal(new, t_lse) and torch.equal(merged, t_acc)


@pytest.mark.parametrize("case", ["zigzag_rank1_hop1", "no_positions"])
def test_bf16_inputs_with_fp32_partials(case):
    """bf16 q/k/v/do with ``out_dtype=float32`` (a ring hop's partial):
    out comes back fp32, lse is fp32, the gradients bf16."""
    Tq, Tk, q_pos, kv_pos, block = CASES[case]
    x = _draw(2, Tq, Tk, seed=11)
    got = _port_run(*x, q_pos, kv_pos, block, torch.bfloat16,
                    out_dtype=torch.float32)
    want = _jax_run(*x, q_pos, kv_pos, block, jnp.bfloat16,
                    out_dtype=jnp.float32)
    _assert_match(got, want, BF16_TOL)
    out, lse = fa.flash_masked_fwd(
        *(torch.from_numpy(a).bfloat16() for a in x[:3]),
        out_dtype=torch.float32)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32


def test_public_route_gradients_match_jax_grad():
    """``flash_attention`` with explicit zigzag positions (some rows dead)
    through ``_FlashMasked``: out and the gradients of ``sum(out * do)``
    against ``jax.grad`` of the JAX ``flash_attention``."""
    q_pos, kv_pos = _zigzag(0, N, TL), _zigzag(2, N, TL)
    q, k, v, do = _draw(2, TL, TL, seed=12)
    kw = dict(causal=True, block_q=16, block_k=16)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos, jnp.int32),
                                  kv_pos=jnp.asarray(kv_pos, jnp.int32),
                                  interpret=True, **kw)
        return jnp.sum(out * do), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = fa.flash_attention(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                              kv_pos=torch.from_numpy(kv_pos), **kw)
    (tout * torch.from_numpy(do)).sum().backward()
    _assert_match([tout.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
                   tv.grad.numpy()],
                  [np.asarray(jout), *(np.asarray(g) for g in jgrads)], TOL,
                  names=("out", "dq", "dk", "dv"))
    assert not tout.detach().numpy()[:, :TL // 2].any()  # rows before every key


def test_wrapper_argument_checks():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="together"):
        fa.flash_masked_fwd(q, q, q, torch.arange(8), None)
    with pytest.raises(ValueError, match="length"):
        fa.flash_masked_fwd(q, q, q, torch.arange(7), torch.arange(8))
    with pytest.raises(TypeError, match="out_dtype"):
        fa.flash_masked_fwd(q, q, q, out_dtype=torch.float16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_masked_kernels_match_plain_versions(dtype, tol):
    """B4-B6 on the card against their plain versions: zigzag positions
    with a ragged chunk, on the strided views of a fused qkv projection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    B, T, Hh, Dh = 2, 200, 3, 64
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, T, 3 * Hh * Dh, generator=g).to(dtype).cuda()
    q, k, v = (x.view(B, T, Hh, Dh) for x in qkv.split(Hh * Dh, dim=-1))
    do = torch.randn(B, T, Hh, Dh, generator=g).to(dtype).cuda()
    pos = [torch.from_numpy(_zigzag(o, 4, T)).cuda() for o in (1, 2)]
    out, lse = fa.flash_masked_fwd(q, k, v, *pos)
    ref_out, ref_lse = fa.flash_masked_fwd_reference(q, k, v, *pos)
    delta = fa.attention_delta(do, ref_out)
    args = (q, k, v, do, ref_lse, delta, *pos)
    got = [out, lse, fa.flash_masked_dq(*args), *fa.flash_masked_dkv(*args)]
    want = [ref_out, ref_lse, fa.flash_masked_dq_reference(*args),
            *fa.flash_masked_dkv_reference(*args)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """The library name hashes the source and every header it includes
    with quotes, transitively: an edited header builds anew (no nvcc
    needed, only the digest is checked)."""
    from pytorch_distributed_tpu_torch.ops import _build

    real = [p.name for p in _build._sources(
        _build._SRC_DIR / "flash_attention_masked.cu")]
    assert real[0] == "flash_attention_masked.cu"
    assert sorted(real[1:]) == ["flash_sm90.cuh", "flash_tiles.cuh"]
    monkeypatch.setattr(_build, "_SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    assert [p.name for p in _build._sources(tmp_path / "k.cu")] == \
        ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")[1]
    assert _build._target("k")[1] == first
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build._target("k")[1] != first
