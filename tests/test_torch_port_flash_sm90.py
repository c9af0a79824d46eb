"""The Hopper route of B1-B6 (bf16/fp16: wgmma tiles fed by TMA), as far
as the CPU can hold it: the C entry points of
``csrc/flash_attention_causal.cu`` and ``csrc/flash_attention_masked.cu``
against the ctypes bindings, the build's tracking of the shared header,
the kernel names the profiles match, the TMA layout rule that the wrappers
enforce before a launch, and the roundings the Hopper B2, B5 and B6 add
(ds, and B6's p, to the input dtype before their products) held against
the JAX kernels. The kernels themselves run only on the card (the
``gpu``-marked tests and ``chip_smoke.py``)."""

import ast
import importlib
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import (
    _bwd as jax_bwd,
    _bwd_pruned as jax_bwd_pruned,
    _fwd as jax_fwd,
    _fwd_pruned as jax_fwd_pruned,
)
from pytorch_distributed_tpu_torch.ops import _build

# the module (the package attribute of the same name is the function)
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")

torch.set_num_threads(2)

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
                                      (MASKED, "flash_masked_fwd"),
                                      (MASKED, "flash_masked_dq"),
                                      (MASKED, "flash_masked_dkv")],
                         ids=["B2", "B4", "B5", "B6"])
def test_b2_b4_sm90_kernels_match_the_profile_names(src, name):
    """The Hopper B2, B4, B5 and B6 are defined in their sources under names
    that hold ``<wrapper>_kernel``, which the profiles match."""
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


@pytest.mark.parametrize("name", ["flash_causal_dq", "flash_masked_fwd",
                                  "flash_masked_dq", "flash_masked_dkv"])
def test_b2_b4_wrappers_check_the_tma_rule(name):
    """The wrappers of the Hopper B2, B4, B5 and B6 check their operands under
    their own names: bf16 at D=60 raises naming the rule, fp32 passes."""
    odd = torch.zeros(2, 16, 3, 60, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"^{name}: .*multiple of 8"):
        fa._check_tma(name, odd, odd, odd)
    fa._check_tma(name, odd.float(), odd.float(), odd.float())
    assert f'_check_tma("{name}", q, k, v' in inspect.getsource(
        getattr(fa, name))


def _dq_with_ds_rounded(q, k, v, do, lse, delta, q_pos, kv_pos,
                        block: int = 64):
    """A copy of the plain masked dq loop (``flash_masked_dq_reference``)
    with ds rounded to the inputs' dtype before ``dq += ds k``, as the
    Hopper B2 and B5 round it; keep = q_pos >= kv_pos (B2's causal mask
    with positions ``arange(T)``) and p = 0 on dead rows (lse <= -1e30 /
    2)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / D ** 0.5
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dq = torch.empty(B, H, Tq, D, dtype=q.dtype)
    for q0 in range(0, Tq, block):
        q1 = min(q0 + block, Tq)
        qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
        lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
        acc = torch.zeros(B, H, q1 - q0, D)
        for k0 in range(0, Tk, block):
            k1 = min(k0 + block, Tk)
            kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
            keep = q_pos[q0:q1, None] >= kv_pos[None, k0:k1]
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
    got = _dq_with_ds_rounded(q, k, v, do, lse, delta, torch.arange(T),
                              torch.arange(T)).float().numpy()
    want = np.asarray(jdq.astype(jnp.float32))
    err = np.abs(got - want)
    assert np.all(err <= 2e-2 * (1 + np.abs(want))), err.max()
    assert np.abs(want).max() > 0.1  # the gradients are not vacuous


def _chip_smoke_constant(name: str):
    """A module-level tuple of ``chip_smoke.py``, read without importing
    the script."""
    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_b6_sm90_kernel_is_profiled_and_counted():
    """``flash_masked_dkv_kernel_sm90``, the source's Hopper B6, is among
    the kernels that ``chip_smoke.py``'s train_cp profile expects n_layer
    times a step and whose registers and HGMMA ``kernel_resources`` reads,
    and the profile's ``<wrapper>_kernel`` key of B6 matches it."""
    kernels = set(re.findall(r"^(flash_masked_\w+)\(", MASKED.read_text(),
                             re.MULTILINE))
    assert "flash_masked_dkv_kernel_sm90" in kernels
    masked_sm90 = _chip_smoke_constant("MASKED_SM90_KERNELS")
    assert masked_sm90 == ("flash_masked_fwd_kernel_sm90",
                           "flash_masked_dq_kernel_sm90",
                           "flash_masked_dkv_kernel_sm90")
    assert all(k in kernels for k in masked_sm90)
    (b6,) = [name for name, key, _ in _chip_smoke_constant("MASKED_KERNELS")
             if key == "mdkv"]
    assert f"{b6}_kernel" in "flash_masked_dkv_kernel_sm90"


def _zigzag(owner, n, T):
    half = T // 2
    return np.concatenate([owner * half + np.arange(half),
                           (2 * n - 1 - owner) * half + np.arange(half)])


def _masked_dkv_rounded(q, k, v, do, lse, delta, q_pos, kv_pos,
                        block: int = 64):
    """A copy of the plain masked dk/dv loop (``flash_masked_dkv_reference``)
    with p^T and ds^T rounded to the inputs' dtype before dv += p^T do and
    dk += ds^T q, as the Hopper B6 rounds them; keep = q_pos >= kv_pos and
    p = 0 on dead rows (lse <= -1e30 / 2)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / D ** 0.5
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dk = torch.empty(B, H, Tk, D, dtype=k.dtype)
    dv = torch.empty(B, H, Tk, D, dtype=v.dtype)
    for k0 in range(0, Tk, block):
        k1 = min(k0 + block, Tk)
        kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
        dk_acc = torch.zeros(B, H, k1 - k0, D)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, Tq, block):
            q1 = min(q0 + block, Tq)
            qb, dob = qt[:, :, q0:q1].float(), dot[:, :, q0:q1].float()
            lse_b, delta_b = lse[:, :, q0:q1], delta[:, :, q0:q1]
            keep = q_pos[q0:q1, None] >= kv_pos[None, k0:k1]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
            p = torch.where(keep, torch.exp(s - lse_b[..., None]), 0.0)
            p = torch.where(lse_b[..., None] <= -1e30 / 2, 0.0, p)
            dv_acc = dv_acc + torch.einsum("bhqk,bhqd->bhkd",
                                           p.to(q.dtype).float(), dob)
            dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
            ds = p * (dp - delta_b[..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bhqk,bhqd->bhkd",
                                           ds.to(q.dtype).float(), qb)
        dk[:, :, k0:k1] = dk_acc.to(k.dtype)
        dv[:, :, k0:k1] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.parametrize("hop", ["diagonal", "zigzag_rank1_hop1"])
def test_b6_rounding_stays_within_the_card_limit(hop):
    """The Hopper B6's one numeric change, rounding p^T and ds^T to bf16
    before dv += p^T do and dk += ds^T q, held against the JAX
    ``_dkv_kernel`` (interpret mode, fp32 p and ds) on bf16 inputs at
    T=128, one head, D=64, on the diagonal hop and on hop 1 of rank 1 of a
    4-rank zigzag ring: within chip_smoke's bf16 limit, |x - jax| <= 2e-2
    (1 + |jax|). Both sides take the JAX forward's out and lse."""
    rng = np.random.default_rng(8)
    B, T, H, D = 2, 128, 1, 64
    if hop == "diagonal":
        q_pos = kv_pos = np.arange(T)
    else:
        q_pos, kv_pos = _zigzag(1, 4, T), _zigzag(0, 4, T)
    x32 = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(4)]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in x32)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in x32)
    jp = [jnp.asarray(p, jnp.int32) for p in (q_pos, kv_pos)]
    kw = dict(block_q=64, block_k=64, interpret=True)
    jout, jlse = jax_fwd(jq, jk, jv, *jp, **kw)
    _, jdk, jdv = jax_bwd(jq, jk, jv, *jp, jout, jlse, jdo, **kw)
    out = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(jlse))
    delta = fa.attention_delta(do, out)
    got = _masked_dkv_rounded(q, k, v, do, lse, delta,
                              torch.from_numpy(q_pos), torch.from_numpy(kv_pos))
    for a, want in zip(got, (jdk, jdv)):
        a = a.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(a - want)
        assert np.all(err <= 2e-2 * (1 + np.abs(want))), err.max()
        assert np.abs(want).max() > 0.1  # the gradients are not vacuous


def test_b5_sm90_kernel_is_profiled_and_counted():
    """``flash_masked_dq_kernel_sm90``, the source's Hopper B5, is among
    the kernels that ``chip_smoke.py``'s train_cp profile expects n_layer
    times a step and whose registers and HGMMA ``kernel_resources`` reads;
    its counter key ``mdq`` is among the keys with a Hopper route, and the
    profile's ``<wrapper>_kernel`` key of B5 matches it."""
    kernels = set(re.findall(r"^(flash_masked_\w+)\(", MASKED.read_text(),
                             re.MULTILINE))
    assert "flash_masked_dq_kernel_sm90" in kernels
    assert "flash_masked_dq_kernel_sm90" in _chip_smoke_constant(
        "MASKED_SM90_KERNELS")
    assert "mdq" in _chip_smoke_constant("SM90_KEYS")
    (b5,) = [name for name, key, _ in _chip_smoke_constant("MASKED_KERNELS")
             if key == "mdq"]
    assert f"{b5}_kernel" in "flash_masked_dq_kernel_sm90"


@pytest.mark.parametrize("hop", ["diagonal", "zigzag_rank1_hop1", "future"])
def test_b5_ds_rounding_stays_within_the_card_limit(hop):
    """The Hopper B5's one numeric change, rounding ds to bf16 before
    dq += ds k, held against the JAX masked backward's dq (``_bwd``:
    ``_dq_kernel`` in interpret mode, fp32 ds) on bf16 inputs at T=128,
    one head, D=64, on the diagonal hop, on hop 1 of rank 1 of a 4-rank
    zigzag ring and on a hop that holds only future keys: within
    chip_smoke's bf16 limit, |x - jax| <= 2e-2 (1 + |jax|); on the
    all-future hop both sides are exactly 0. Both sides take the JAX
    forward's out and lse."""
    rng = np.random.default_rng(9)
    B, T, H, D = 2, 128, 1, 64
    q_pos, kv_pos = {
        "diagonal": (np.arange(T), np.arange(T)),
        "zigzag_rank1_hop1": (_zigzag(1, 4, T), _zigzag(0, 4, T)),
        "future": (np.arange(T), T + np.arange(T)),
    }[hop]
    x32 = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(4)]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in x32)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in x32)
    jp = [jnp.asarray(p, jnp.int32) for p in (q_pos, kv_pos)]
    kw = dict(block_q=64, block_k=64, interpret=True)
    jout, jlse = jax_fwd(jq, jk, jv, *jp, **kw)
    jdq = jax_bwd(jq, jk, jv, *jp, jout, jlse, jdo, **kw)[0]
    out = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(jlse))
    delta = fa.attention_delta(do, out)
    got = _dq_with_ds_rounded(q, k, v, do, lse, delta,
                              torch.from_numpy(q_pos),
                              torch.from_numpy(kv_pos)).float().numpy()
    want = np.asarray(jdq.astype(jnp.float32))
    if hop == "future":
        assert not got.any() and not want.any()
        return
    err = np.abs(got - want)
    assert np.all(err <= 2e-2 * (1 + np.abs(want))), err.max()
    assert np.abs(want).max() > 0.1  # the gradients are not vacuous
