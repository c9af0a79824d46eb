"""The Hopper route of B1-B4 (bf16/fp16: wgmma tiles fed by TMA), as far
as the CPU can hold it: the C entry points of
``csrc/flash_attention_causal.cu`` and ``csrc/flash_attention_masked.cu``
against the ctypes bindings, the build's tracking of the shared header,
the kernel names the profiles match, the TMA layout rule that the wrappers
enforce before a launch, and the one rounding the Hopper B2 adds (ds to
the input dtype before dq += ds k) held against the JAX kernel. The
kernels themselves run only on the card (the ``gpu``-marked tests and
``chip_smoke.py``)."""

import importlib
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import (
    _bwd_pruned as jax_bwd_pruned,
    _fwd_pruned as jax_fwd_pruned,
)
from pytorch_distributed_tpu_torch.ops import _build

# the module (the package attribute of the same name is the function)
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")

CAUSAL = _build._SRC_DIR / "flash_attention_causal.cu"
MASKED = _build._SRC_DIR / "flash_attention_masked.cu"
C, T, H, D = 768, 1024, 12, 64          # GPT-2 125M: c_attn gives [B, T, 3C]
BASE = 0x7F3A_0000_0000                  # a 16-byte aligned address


def _entry_points(text: str) -> dict:
    """``extern "C"`` functions of a source: name -> argument count."""
    return {name: len([a for a in args.split(",") if a.strip()])
            for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         text)}


def test_entry_points_match_bindings():
    want = {name: len(args) for name, args in fa.CAUSAL_SIGNATURES}
    assert _entry_points(CAUSAL.read_text()) == want


def test_masked_entry_points_match_bindings():
    want = {name: len(args) for name, args in fa.MASKED_SIGNATURES}
    assert _entry_points(MASKED.read_text()) == want


def test_build_tracks_the_sm90_header():
    names = [p.name for p in _build._sources(CAUSAL)]
    assert names[0] == "flash_attention_causal.cu"
    assert {"flash_sm90.cuh", "flash_tiles.cuh"} <= set(names)


def test_masked_build_tracks_the_sm90_header():
    names = [p.name for p in _build._sources(MASKED)]
    assert names[0] == "flash_attention_masked.cu"
    assert {"flash_sm90.cuh", "flash_tiles.cuh"} <= set(names)


def test_sm90_kernel_names_match_the_profile_names():
    """chip_smoke.py attributes profiled kernels by ``<name>_kernel``."""
    kernels = set(re.findall(r"^(flash_causal_\w+)\(", CAUSAL.read_text(),
                             re.MULTILINE))
    assert {"flash_causal_fwd_kernel_sm90",
            "flash_causal_dkv_kernel_sm90"} <= kernels
    for name in ("flash_causal_fwd", "flash_causal_dkv"):
        assert f"{name}_kernel" in f"{name}_kernel_sm90"


@pytest.mark.parametrize("src,name", [(CAUSAL, "flash_causal_dq"),
                                      (MASKED, "flash_masked_fwd")],
                         ids=["B2", "B4"])
def test_b2_b4_sm90_kernels_match_the_profile_names(src, name):
    """The Hopper B2 and B4 are defined in their sources under names that
    hold ``<wrapper>_kernel``, which the profiles match."""
    kernels = set(re.findall(r"^(flash_\w+)\(", src.read_text(),
                             re.MULTILINE))
    sm90 = [k for k in kernels if k.endswith("_sm90")]
    assert f"{name}_kernel_sm90" in sm90
    assert [k for k in sm90 if f"{name}_kernel" in k] == [f"{name}_kernel_sm90"]


@pytest.mark.parametrize("offset", [0, C, 2 * C])
def test_tma_rule_accepts_gpt2_fused_views(offset):
    """q, k and v of c_attn's split: strides (T 3C, 3C, D), elements 0, C
    and 2C into the fused projection."""
    shape, strides = (8, T, H, D), (T * 3 * C, 3 * C, D, 1)
    assert fa.tma_layout_error(shape, strides, 2, BASE + 2 * offset) is None


@pytest.mark.parametrize("shape,strides,ptr,rule", [
    ((8, T, H, 60), (T * H * 60, H * 60, 60, 1), BASE, "multiple of 8"),
    ((8, T, H, D), (T * (3 * C + 1), 3 * C + 1, D, 1), BASE, "T stride"),
    ((8, T, H, D), (T * 3 * C, 3 * C, D, 1), BASE + 2, "16-byte aligned"),
], ids=["D=60", "odd row stride", "misaligned base"])
def test_tma_rule_rejects(shape, strides, ptr, rule):
    err = fa.tma_layout_error(shape, strides, 2, ptr)
    assert err is not None and rule in err


def test_tma_rule_ignores_strides_of_unit_dims():
    """B = H = 1: their strides are never stepped."""
    assert fa.tma_layout_error((1, T, 1, D), (3, 3 * C, 5, 1), 2, BASE) is None


def test_wrapper_raises_naming_the_rule():
    """The wrapper's check on 16-bit operands; fp32 goes to the CUDA-core
    kernels and is not held to it."""
    odd = torch.zeros(2, 16, 3, 60, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._check_tma("flash_causal_fwd", odd)
    fa._check_tma("flash_causal_fwd", odd.float())


@pytest.mark.parametrize("name", ["flash_causal_dq", "flash_masked_fwd"])
def test_b2_b4_wrappers_check_the_tma_rule(name):
    """The wrappers of the Hopper B2 and B4 check their operands under
    their own names: bf16 at D=60 raises naming the rule, fp32 passes."""
    odd = torch.zeros(2, 16, 3, 60, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"^{name}: .*multiple of 8"):
        fa._check_tma(name, odd, odd, odd)
    fa._check_tma(name, odd.float(), odd.float(), odd.float())
    assert f'_check_tma("{name}", q, k, v' in inspect.getsource(
        getattr(fa, name))


def _dq_with_ds_rounded(q, k, v, do, lse, delta, block: int = 64):
    """A copy of the plain dq loop (``flash_causal_dq_reference``) with ds
    rounded to the inputs' dtype before ``dq += ds k``, as the Hopper B2
    rounds it."""
    B, T, H, D = q.shape
    scale = 1.0 / D ** 0.5
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dq = torch.empty(B, H, T, D, dtype=q.dtype)
    for q0 in range(0, T, block):
        q1 = min(q0 + block, T)
        qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
        lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
        acc = torch.zeros(B, H, q1 - q0, D)
        for k0 in range(0, q1, block):
            k1 = min(k0 + block, T)
            kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
            keep = (torch.arange(q0, q1)[:, None]
                    >= torch.arange(k0, k1)[None, :])
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
            p = torch.where(keep, torch.exp(s - lse_b[..., None]), 0.0)
            p = torch.where(lse_b[..., None] <= -1e30 / 2, 0.0, p)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            acc = acc + torch.einsum("bhqk,bhkd->bhqd",
                                     ds.to(q.dtype).float(), kb)
        dq[:, :, q0:q1] = acc.to(q.dtype)
    return dq.transpose(1, 2)


def test_b2_ds_rounding_stays_within_the_card_limit():
    """The Hopper B2's one numeric change, rounding ds to bf16 before
    dq += ds k, held against the JAX ``_dq_kernel_pruned`` (interpret mode,
    fp32 ds) on bf16 inputs at T=64, one head: within chip_smoke's bf16
    limit, |x - jax| <= 2e-2 (1 + |jax|). Both sides take the JAX
    forward's out and lse."""
    rng = np.random.default_rng(7)
    B, T, H, D = 2, 64, 1, 64
    x32 = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(4)]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in x32)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in x32)
    kw = dict(block_q=32, block_k=32, interpret=True)
    jout, jlse = jax_fwd_pruned(jq, jk, jv, **kw)
    jdq = jax_bwd_pruned(jq, jk, jv, jout, jlse, jdo, **kw)[0]
    out = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(jlse))
    delta = fa.attention_delta(do, out)
    got = _dq_with_ds_rounded(q, k, v, do, lse, delta).float().numpy()
    want = np.asarray(jdq.astype(jnp.float32))
    err = np.abs(got - want)
    assert np.all(err <= 2e-2 * (1 + np.abs(want))), err.max()
    assert np.abs(want).max() > 0.1  # the gradients are not vacuous
