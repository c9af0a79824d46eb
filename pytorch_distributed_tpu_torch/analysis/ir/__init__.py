"""graftir for the port: the IR-tier audit beside graftlint's AST tier.

Port of ``pytorch_distributed_tpu/analysis/ir``. Where graftlint reads
source text, graftir reads what the port's step actually does: it builds
the port's own step programs (strategy x AMP grid over the probe MLP) as
``Trainer``/``AsyncRunner`` would, runs them on the process group's ranks
and audits

* the collective inventory (``parallel.comm``'s record of the step) and
  its byte budget per strategy signature,
* the in-place update of every state tensor (the counterpart of the
  reference's donation aliasing),
* structural ``programs_per_step == 1`` on the runner path (one
  ``Program``, one dispatch a submit),
* the held layout against the strategy's declared specs,

with the numbers pinned in a committed, platform-stamped ``BUDGET.json``
whose ``--diff`` mode fails on unreviewed drift. See ``../RULES.md`` ("IR
tier").

CLI::

    python -m pytorch_distributed_tpu_torch.analysis.ir --grid full --diff
    python -m pytorch_distributed_tpu_torch.analysis.ir --grid full --write-budget

Unlike the lint tier this package imports torch; ``analysis`` itself never
imports it.
"""

from pytorch_distributed_tpu_torch.analysis.ir.audit import (
    CHECKS,
    AuditReport,
    ProgramAudit,
    audit_program,
    inplace_findings,
    run_audit,
)
from pytorch_distributed_tpu_torch.analysis.ir.budget import (
    DEFAULT_BUDGET_PATH,
    diff_budget,
    load_budget,
    write_budget,
)
from pytorch_distributed_tpu_torch.analysis.ir.inventory import (
    CollectiveOp,
    collective_inventory,
    summarize_collectives,
)
from pytorch_distributed_tpu_torch.analysis.ir.programs import (
    FAST_GRID,
    FULL_GRID,
    ProbeMLP,
    StepProgram,
    build_grid,
    build_program,
)

__all__ = [
    "CHECKS",
    "AuditReport",
    "ProgramAudit",
    "audit_program",
    "inplace_findings",
    "run_audit",
    "DEFAULT_BUDGET_PATH",
    "diff_budget",
    "load_budget",
    "write_budget",
    "CollectiveOp",
    "collective_inventory",
    "summarize_collectives",
    "FAST_GRID",
    "FULL_GRID",
    "ProbeMLP",
    "StepProgram",
    "build_grid",
    "build_program",
]
