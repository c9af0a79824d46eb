"""Ops of the port: plain torch ops and the CUDA kernels (paged decode,
causal and position-masked flash attention forward and backward,
BatchNorm over a stats group).

Exports are lazy (PEP 562), as in the JAX package's ``ops``: importing this
package loads no op module, and no kernel is built until a CUDA tensor
reaches its wrapper, so the package imports on a machine without ``nvcc``.
"""

_FLASH = "pytorch_distributed_tpu_torch.ops.flash_attention"
_LAZY = {
    "cached_attention": "pytorch_distributed_tpu_torch.ops.decode_attention",
    "chunked_cross_entropy": "pytorch_distributed_tpu_torch.ops.chunked_xent",
    "flash_attention": _FLASH,
    "flash_attention_with_lse": _FLASH,
    "flash_causal_dkv": _FLASH,
    "flash_causal_dkv_reference": _FLASH,
    "flash_causal_dq": _FLASH,
    "flash_causal_dq_reference": _FLASH,
    "flash_causal_fwd": _FLASH,
    "flash_causal_fwd_reference": _FLASH,
    "flash_masked_dkv": _FLASH,
    "flash_masked_dkv_reference": _FLASH,
    "flash_masked_dq": _FLASH,
    "flash_masked_dq_reference": _FLASH,
    "flash_masked_fwd": _FLASH,
    "flash_masked_fwd_reference": _FLASH,
    "paged_cached_attention": "pytorch_distributed_tpu_torch.ops.paged_attention",
    "paged_decode_attention": "pytorch_distributed_tpu_torch.ops.paged_attention",
    "paged_decode_attention_reference":
        "pytorch_distributed_tpu_torch.ops.paged_attention",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
