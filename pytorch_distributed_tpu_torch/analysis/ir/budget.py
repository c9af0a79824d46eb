"""graftir budget baseline: the committed ``BUDGET.json``.

Port of ``pytorch_distributed_tpu/analysis/ir/budget.py``, with its
version, fingerprint and ``--diff`` semantics. Mirrors graftlint's
baseline mode but pins *numbers*, not fingerprints: per program, the
tensor/scalar collective counts and bytes, the in-place counts, the
sharding-propagation counts and bytes, and the structural
programs-per-step evidence. ``--diff`` compares a fresh audit
against the committed file and fails CI naming every drifted value — a
comm-bytes regression (or a silently dropped donation) cannot merge
without the baseline being regenerated in the same change (``python -m
pytorch_distributed_tpu_torch.analysis.ir --grid full --write-budget``),
which makes the regression reviewable.

Budgets are platform-stamped (``"cpu"`` for the gloo ranks, ``"gpu"`` on
the card) with the rank count, and only ever diff against a run on the
same platform and rank count. The committed one is the CPU's: the full
grid on 4 gloo ranks.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

from pytorch_distributed_tpu_torch.analysis.ir.audit import AuditReport

__all__ = [
    "DEFAULT_BUDGET_PATH",
    "budget_payload",
    "write_budget",
    "load_budget",
    "diff_budget",
]

_VERSION = 1

#: the committed baseline, next to this module (like RULES.md)
DEFAULT_BUDGET_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "BUDGET.json"
)


def _fingerprint(programs: Dict, platform: str, device_count: int) -> str:
    blob = json.dumps(
        {"programs": programs, "platform": platform,
         "device_count": device_count},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def budget_payload(report: AuditReport) -> Dict:
    programs = report.entries
    return {
        "version": _VERSION,
        "platform": report.platform,
        "device_count": report.device_count,
        "grid": report.grid,
        "programs": programs,
        "fingerprint": _fingerprint(
            programs, report.platform, report.device_count
        ),
    }


def write_budget(path: str, report: AuditReport) -> Dict:
    payload = budget_payload(report)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return payload


def load_budget(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("version") != _VERSION:
        raise ValueError(
            f"budget {path}: unsupported version "
            f"{payload.get('version')!r} (expected {_VERSION})"
        )
    return payload


def _flatten(entry, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    if isinstance(entry, dict):
        for k, v in entry.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    else:
        out[prefix] = entry
    return out


def diff_budget(
    baseline: Dict, report: AuditReport
) -> Tuple[bool, List[str]]:
    """``(comparable, diffs)``. Not comparable (platform or device count
    differ) means the baseline simply doesn't apply to this run — the
    caller reports that and exits clean rather than inventing drift."""
    current = budget_payload(report)
    if (
        baseline.get("platform") != current["platform"]
        or baseline.get("device_count") != current["device_count"]
    ):
        return False, [
            f"baseline stamped for {baseline.get('platform')}"
            f"×{baseline.get('device_count')} devices, this run is "
            f"{current['platform']}×{current['device_count']} — not "
            f"comparable, skipping diff"
        ]
    diffs: List[str] = []
    base_programs = baseline.get("programs") or {}
    for name, entry in current["programs"].items():
        base = base_programs.get(name)
        if base is None:
            diffs.append(
                f"{name}: program not in baseline — regenerate with "
                f"`python -m pytorch_distributed_tpu_torch.analysis.ir "
                f"--grid full --write-budget`"
            )
            continue
        flat_new = _flatten(entry)
        flat_old = _flatten(base)
        for key in sorted(set(flat_old) | set(flat_new)):
            old, new = flat_old.get(key), flat_new.get(key)
            if old != new:
                diffs.append(f"{name}: {key} changed {old!r} -> {new!r}")
    if baseline.get("grid") == report.grid:
        for name in sorted(set(base_programs) - set(current["programs"])):
            diffs.append(
                f"{name}: in baseline but absent from this "
                f"{report.grid!r}-grid run"
            )
    return True, diffs
