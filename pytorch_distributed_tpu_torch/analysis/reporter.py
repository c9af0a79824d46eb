"""graftlint reporters: human text and machine-readable JSON.

Port of ``pytorch_distributed_tpu/analysis/reporter.py``: the same JSON
schema and summary keys, shared by the lint and IR tiers."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from pytorch_distributed_tpu_torch.analysis.core import Finding

__all__ = ["render_text", "render_json"]


def _summary_counts(findings: Sequence[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return dict(sorted(counts.items()))


def render_text(
    findings: Sequence[Finding], *, files: int,
    suppressed: int = 0, baselined: int = 0,
    tool: str = "graftlint", unit: str = "files",
) -> str:
    lines: List[str] = [f.render() for f in findings]
    tail = (
        f"{tool}: {len(findings)} finding"
        f"{'' if len(findings) == 1 else 's'} across {files} {unit}"
    )
    extras = []
    if suppressed:
        extras.append(f"{suppressed} suppressed")
    if baselined:
        extras.append(f"{baselined} baselined")
    if extras:
        tail += f" ({', '.join(extras)})"
    by_rule = _summary_counts(findings)
    if by_rule:
        tail += "\n" + "\n".join(
            f"  {rule}: {n}" for rule, n in by_rule.items()
        )
    lines.append(tail)
    return "\n".join(lines)


def render_json(
    findings: Sequence[Finding], *, files: int,
    suppressed: int = 0, baselined: int = 0,
    rules: Optional[Sequence[str]] = None,
) -> str:
    payload = {
        "version": 1,
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "files": files,
            "findings": len(findings),
            "suppressed": suppressed,
            "baselined": baselined,
            "by_rule": _summary_counts(findings),
            "rules_run": sorted(rules or ()),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)
