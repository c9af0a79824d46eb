"""Precision policy: the compute/param/output dtypes and cast helpers.

Port of ``pytorch_distributed_tpu/amp/policy.py`` over torch dtypes. The
model's own ``dtype`` sets its compute precision; the policy casts the
batch's floating tensors and says whether loss scaling is needed (fp16).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Policy", "get_policy"]


def _cast_tree(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_tree(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast_tree(tree, self.compute_dtype)

    @property
    def needs_loss_scaling(self) -> bool:
        return self.compute_dtype == torch.float16


_POLICIES = {
    "fp32": Policy(),
    "float32": Policy(),
    "bf16": Policy(compute_dtype=torch.bfloat16),
    "bfloat16": Policy(compute_dtype=torch.bfloat16),
    # full-half: params too (memory-bound inference-style)
    "bf16_full": Policy(torch.bfloat16, torch.bfloat16, torch.bfloat16),
    "fp16": Policy(compute_dtype=torch.float16),
    "float16": Policy(compute_dtype=torch.float16),
}


def get_policy(name_or_policy) -> Policy:
    """'bf16' / 'fp16' / 'fp32' or an explicit Policy."""
    if isinstance(name_or_policy, Policy):
        return name_or_policy
    try:
        return _POLICIES[str(name_or_policy)]
    except KeyError:
        raise ValueError(
            f"unknown policy {name_or_policy!r}; one of {sorted(_POLICIES)}"
        ) from None
