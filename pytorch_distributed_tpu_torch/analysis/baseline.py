"""Baseline support: land a new rule without blocking on day one.

Port of ``pytorch_distributed_tpu/analysis/baseline.py``, in the same file
format and version, so a baseline written by either package is read by the
other. ``--write-baseline FILE`` records the fingerprints of every current
finding; running with ``--baseline FILE`` subtracts them, so only *new*
findings (or findings whose message/symbol changed) fail the build.
Fingerprints are line-insensitive (rule + path + enclosing symbol +
message), so unrelated edits above a baselined finding don't resurrect
it."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from pytorch_distributed_tpu_torch.analysis.core import Finding

__all__ = ["write_baseline", "load_baseline", "apply_baseline"]

_VERSION = 1


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "version": _VERSION,
        "fingerprints": sorted({f.fingerprint() for f in findings}),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("version") != _VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version "
            f"{payload.get('version')!r} (expected {_VERSION})"
        )
    return payload


def apply_baseline(
    findings: Sequence[Finding], baseline: Dict
) -> Tuple[List[Finding], List[Finding]]:
    """Returns (new_findings, baselined)."""
    known = set(baseline.get("fingerprints") or ())
    fresh, old = [], []
    for f in findings:
        (old if f.fingerprint() in known else fresh).append(f)
    return fresh, old
