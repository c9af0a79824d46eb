"""The Hopper route of B1 and B3 (bf16/fp16: wgmma tiles fed by TMA), as
far as the CPU can hold it: the C entry points of
``csrc/flash_attention_causal.cu`` against the ctypes bindings, the
build's tracking of the new header, the kernel names the profiles match,
and the TMA layout rule that the wrapper enforces before a launch. The
kernels themselves run only on the card (the ``gpu``-marked tests and
``chip_smoke.py``)."""

import importlib
import re

import pytest
import torch

from pytorch_distributed_tpu_torch.ops import _build

# the module (the package attribute of the same name is the function)
fa = importlib.import_module("pytorch_distributed_tpu_torch.ops.flash_attention")

CAUSAL = _build._SRC_DIR / "flash_attention_causal.cu"
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


def test_build_tracks_the_sm90_header():
    names = [p.name for p in _build._sources(CAUSAL)]
    assert names[0] == "flash_attention_causal.cu"
    assert {"flash_sm90.cuh", "flash_tiles.cuh"} <= set(names)


def test_sm90_kernel_names_match_the_profile_names():
    """chip_smoke.py attributes profiled kernels by ``<name>_kernel``."""
    kernels = set(re.findall(r"^(flash_causal_\w+)\(", CAUSAL.read_text(),
                             re.MULTILINE))
    assert {"flash_causal_fwd_kernel_sm90",
            "flash_causal_dkv_kernel_sm90"} <= kernels
    for name in ("flash_causal_fwd", "flash_causal_dkv"):
        assert f"{name}_kernel" in f"{name}_kernel_sm90"


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
