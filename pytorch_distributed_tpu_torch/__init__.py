"""PyTorch/CUDA port of ``pytorch_distributed_tpu``, for an NVIDIA H100.

The JAX package stays as the reference; this package grows beside it slice
by slice and imports nothing of it (nor of JAX). Slice 1 is GPT-2 serving
through the paged KV cache, slice 2 GPT-2 training on one card, slice 3
context-parallel training (``parallel.context_parallel`` over
``distributed`` and ``mesh``); their kernels are written in CUDA C++
(``ops/csrc``). Slice 8 is ResNet training under ``DataParallel``
(``models.resnet``, ``examples.train_resnet_ddp``, the bench twin
``bench``), on cuDNN and cuBLAS. Slice 9 is speculative decoding, live
weight swaps and the serving entry point ``examples.serve_gpt2``.
``checkpoint`` and ``elastic`` save and resume training, and restart the
workers that die (``python -m pytorch_distributed_tpu_torch.elastic.run``).
Entry points run on the card unless the caller passes ``device="cpu"``.
``analysis`` lints the package (stdlib only) and audits its step programs.

Importing the package imports nothing else: ``resolve_device`` (and torch
with it) loads at its first use, so that the stdlib-only linter
(``python -m pytorch_distributed_tpu_torch.analysis``) runs where torch
is not installed.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from pytorch_distributed_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
