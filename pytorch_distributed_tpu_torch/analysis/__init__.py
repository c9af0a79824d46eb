"""graftlint for the port: static analysis of the PyTorch/CUDA stack.

Port of ``pytorch_distributed_tpu/analysis``. Two tiers, as in the
reference:

* the lint tier (this package): an AST rule engine that imports only the
  stdlib and never the code it lints. Its five rules carry their torch
  meaning: host syncs in step loops (``.item()``, ``.cpu()``,
  ``torch.cuda.synchronize()``), host arrays staged inline as collective
  arguments, one eager collective per parameter, mesh-axis names no mesh
  declares, and reshards written by hand outside ``redistribute``. See
  ``RULES.md`` in this directory for the catalogue with bad/good
  examples;
* the IR tier (``analysis.ir``, which imports torch): an audit of the
  port's own step programs, from the collectives the step issues
  (``parallel.comm``'s record), its in-place updates and its CUDA-graph
  ``Program`` count, pinned in a committed ``ir/BUDGET.json``.

CLI::

    python -m pytorch_distributed_tpu_torch.analysis pytorch_distributed_tpu_torch/
    python -m pytorch_distributed_tpu_torch.analysis.ir --grid full --diff

Suppression::

    x = t.item()  # graftlint: disable=host-sync-in-hot-loop -- why
"""

from pytorch_distributed_tpu_torch.analysis.core import (
    AnalysisResult,
    Finding,
    Module,
    Rule,
    all_rules,
    analyze_paths,
    analyze_source,
    get_rules,
    register,
)

__all__ = [
    "AnalysisResult",
    "Finding",
    "Module",
    "Rule",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "get_rules",
    "register",
]
