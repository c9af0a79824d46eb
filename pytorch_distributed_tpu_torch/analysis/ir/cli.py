"""graftir CLI for the port: ``python -m pytorch_distributed_tpu_torch.analysis.ir``.

Port of ``pytorch_distributed_tpu/analysis/ir/cli.py``: builds the port's
own step programs (the strategy x AMP grid over the probe MLP) on
``--ranks`` gloo ranks on the CPU (spawned, one process each, over a
FileStore in a temporary directory), audits them (collective budget,
in-place update, programs per step, sharding propagation) and optionally
diffs the numbers against the committed ``BUDGET.json``. The budget entry
is rank 0's; every rank's findings are reported, and a rank whose entry
differs from rank 0's is a finding too.

Exit codes match graftlint: 0 clean, 1 findings (including budget
drift), 2 usage/config error. The ``--format json`` schema is graftlint's
reporter schema, so one shape serves both tiers.

Typical use::

    python -m pytorch_distributed_tpu_torch.analysis.ir --grid full --diff
    python -m pytorch_distributed_tpu_torch.analysis.ir --grid full --write-budget
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

__all__ = ["main", "build_parser", "audit_on_ranks"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftir-torch",
        description=(
            "IR-level auditor for the port's train-step programs: "
            "collective byte budgets, in-place updates, programs per "
            "step, and sharding propagation, per sharding strategy."
        ),
    )
    p.add_argument(
        "--grid", choices=("fast", "full"), default="fast",
        help="strategy x AMP grid: fast = DP+ZeRO1, full = +FSDP+Hybrid",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (json matches graftlint's schema)",
    )
    p.add_argument(
        "--budget", default=None, metavar="FILE",
        help="budget baseline file (default: the committed "
             "analysis/ir/BUDGET.json)",
    )
    p.add_argument(
        "--diff", action="store_true",
        help="fail when audited numbers drift from the budget baseline",
    )
    p.add_argument(
        "--write-budget", action="store_true",
        help="(re)stamp the budget baseline from this run and exit 0",
    )
    p.add_argument(
        "--list-checks", action="store_true",
        help="print the check catalog and exit",
    )
    p.add_argument(
        "--ranks", type=int, default=4, metavar="N",
        help="gloo ranks to spawn on the CPU (default 4)",
    )
    return p


def _rank(rank: int, store_dir: str, world: int, grid: str) -> None:
    """One rank: audit the grid, write its report as JSON."""
    from datetime import timedelta

    import torch

    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch.analysis.ir.audit import run_audit

    torch.set_num_threads(1)
    pdist.init_process_group(init_method=f"file://{store_dir}/store",
                             rank=rank, world_size=world, device="cpu",
                             timeout=timedelta(seconds=120))
    try:
        report = run_audit(grid)
    finally:
        pdist.destroy_process_group()
    payload = {
        "platform": report.platform,
        "device_count": report.device_count,
        "audits": [{"name": a.name, "entry": a.entry,
                    "findings": [f.to_dict() for f in a.findings],
                    "losses": a.losses} for a in report.audits],
    }
    with open(os.path.join(store_dir, f"rank{rank}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(payload, fh)


def audit_on_ranks(grid: str = "fast", ranks: int = 4,
                   timeout: float = 600.0):
    """The grid audited on ``ranks`` spawned gloo ranks: an
    ``AuditReport`` with rank 0's entries and losses and every rank's
    findings (deduplicated)."""
    import torch.multiprocessing as mp

    from pytorch_distributed_tpu_torch.analysis.core import Finding
    from pytorch_distributed_tpu_torch.analysis.ir.audit import (
        AuditReport,
        ProgramAudit,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(tmp, ranks, grid),
                                 nprocs=ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for proc in ctx.processes:
                        proc.kill()
                    raise RuntimeError(
                        f"the ranks did not finish in {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"a rank failed: {e}") from e
        payloads = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json"),
                      encoding="utf-8") as fh:
                payloads.append(json.load(fh))
    audits = []
    for i, a in enumerate(payloads[0]["audits"]):
        seen, findings = set(), []
        for r, payload in enumerate(payloads):
            other = payload["audits"][i]
            fs = [Finding(**f) for f in other["findings"]]
            if other["entry"] != a["entry"]:
                fs.append(Finding(
                    rule="ir-budget-drift", path=f"ir:{a['name']}", line=1,
                    col=1, symbol=a["name"],
                    message=f"rank {r}'s entry differs from rank 0's: "
                            f"{other['entry']} != {a['entry']}"))
            for f in fs:
                if f.fingerprint() not in seen:
                    seen.add(f.fingerprint())
                    findings.append(f)
        audits.append(ProgramAudit(name=a["name"], entry=a["entry"],
                                   findings=findings, losses=a["losses"]))
    return AuditReport(grid=grid, platform=payloads[0]["platform"],
                       device_count=payloads[0]["device_count"],
                       audits=audits)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from pytorch_distributed_tpu_torch.analysis import reporter
    from pytorch_distributed_tpu_torch.analysis.core import Finding
    from pytorch_distributed_tpu_torch.analysis.ir import audit as audit_mod
    from pytorch_distributed_tpu_torch.analysis.ir import budget as budget_mod

    if args.list_checks:
        for name, desc in sorted(audit_mod.CHECKS.items()):
            print(f"{name}\n    {desc}")
        return 0

    budget_path = args.budget or budget_mod.DEFAULT_BUDGET_PATH

    try:
        report = audit_on_ranks(args.grid, args.ranks)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"graftir: {e}", file=sys.stderr)
        return 2

    if args.write_budget:
        payload = budget_mod.write_budget(budget_path, report)
        print(
            f"graftir: wrote budget for {len(payload['programs'])} "
            f"program(s) [{payload['platform']}x"
            f"{payload['device_count']}, fingerprint "
            f"{payload['fingerprint']}] to {budget_path}"
        )
        return 0

    findings = report.findings
    if args.diff:
        try:
            baseline = budget_mod.load_budget(budget_path)
        except (OSError, ValueError) as e:
            print(f"graftir: budget error: {e}", file=sys.stderr)
            return 2
        comparable, diffs = budget_mod.diff_budget(baseline, report)
        if not comparable:
            for d in diffs:
                print(f"graftir: note: {d}", file=sys.stderr)
        else:
            findings = findings + [
                Finding(
                    rule="ir-budget-drift", path="ir:BUDGET.json",
                    line=1, col=1, message=d,
                )
                for d in diffs
            ]

    kwargs = dict(files=len(report.audits), suppressed=0, baselined=0)
    if args.format == "json":
        print(reporter.render_json(
            findings, rules=sorted(audit_mod.CHECKS), **kwargs
        ))
    else:
        print(reporter.render_text(
            findings, tool="graftir", unit="programs", **kwargs
        ))
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
