"""graftlint CLI for the port: ``python -m pytorch_distributed_tpu_torch.analysis``.

Port of ``pytorch_distributed_tpu/analysis/cli.py``, with every flag of
its ``build_parser``. Exit codes: 0 clean (possibly after
suppressions/baseline), 1 findings, 2 usage/config error.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional, Sequence, Set

from pytorch_distributed_tpu_torch.analysis import baseline as baseline_mod
from pytorch_distributed_tpu_torch.analysis import config as config_mod
from pytorch_distributed_tpu_torch.analysis import reporter
from pytorch_distributed_tpu_torch.analysis.core import (
    all_rules, analyze_paths, get_rules,
)

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint-torch",
        description=(
            "static analyzer for the PyTorch/CUDA training and serving "
            "stack: host syncs in step loops, staged collective "
            "arguments, per-parameter collectives, mesh-axis typos and "
            "hand-rolled reshards."
        ),
    )
    p.add_argument(
        "paths", nargs="*", default=["."],
        help="files or directories to analyze (default: .)",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule names to run (default: config/all)",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="subtract findings recorded in FILE (see --write-baseline)",
    )
    p.add_argument(
        "--write-baseline", default=None, metavar="FILE",
        help="record current findings to FILE and exit 0",
    )
    p.add_argument(
        "--config", default=None, metavar="PYPROJECT",
        help="explicit pyproject.toml (default: nearest to first path)",
    )
    p.add_argument(
        "--no-config", action="store_true",
        help="ignore [tool.graftlint-torch] and the repo defaults",
    )
    p.add_argument(
        "--no-justification-check", action="store_true",
        help="allow suppressions without a '-- reason' justification",
    )
    p.add_argument(
        "--changed-only", action="store_true",
        help="rule-check only files changed vs git HEAD (plus "
             "untracked): seconds on large trees for pre-commit; the "
             "cross-file index still covers everything, and the flag "
             "falls back to a full run outside a git repo",
    )
    return p


def _git_changed_files(cwd: str = ".") -> Optional[Set[str]]:
    """Absolute paths of files changed vs HEAD plus untracked files, or
    None when git is unavailable / not a work tree (callers fall back
    to a full-project run)."""
    def run(*cmd: str) -> Optional[List[str]]:
        try:
            res = subprocess.run(
                cmd, cwd=cwd, capture_output=True, text=True, check=True,
            )
        except (OSError, subprocess.CalledProcessError):
            return None
        return [line for line in res.stdout.splitlines() if line.strip()]

    top = run("git", "rev-parse", "--show-toplevel")
    if not top:
        return None
    changed = run("git", "diff", "--name-only", "HEAD")
    untracked = run("git", "ls-files", "--others", "--exclude-standard")
    if changed is None or untracked is None:
        return None
    return {
        os.path.abspath(os.path.join(top[0], f))
        for f in changed + untracked
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_rules().items()):
            print(f"{name}\n    {cls.description}")
        return 0

    try:
        if args.no_config:
            config = {}
        else:
            pyproject = args.config or config_mod.find_pyproject(
                args.paths[0]
            )
            config = config_mod.load_config(pyproject)
        if args.rules:
            config = dict(config)
            config["enable"] = [
                r.strip() for r in args.rules.split(",") if r.strip()
            ]
            config.pop("disable", None)
        rules = get_rules(config)
    except (ValueError, SyntaxError) as e:
        print(f"graftlint: config error: {e}", file=sys.stderr)
        return 2

    only_files = None
    if args.changed_only:
        only_files = _git_changed_files()
        if only_files is None:
            print(
                "graftlint: --changed-only: not a git work tree, "
                "analyzing everything",
                file=sys.stderr,
            )

    result = analyze_paths(
        args.paths, rules,
        excludes=config_mod.effective_excludes(config),
        require_justification=not args.no_justification_check,
        only_files=only_files,
    )
    findings = result.findings

    if args.write_baseline:
        baseline_mod.write_baseline(args.write_baseline, findings)
        print(
            f"graftlint: wrote baseline with {len(findings)} "
            f"fingerprint(s) to {args.write_baseline}"
        )
        return 0

    baselined: List = []
    if args.baseline:
        try:
            base = baseline_mod.load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"graftlint: baseline error: {e}", file=sys.stderr)
            return 2
        findings, baselined = baseline_mod.apply_baseline(findings, base)

    kwargs = dict(
        files=result.files, suppressed=len(result.suppressed),
        baselined=len(baselined),
    )
    if args.format == "json":
        print(reporter.render_json(
            findings, rules=[r.name for r in rules], **kwargs
        ))
    else:
        print(reporter.render_text(findings, **kwargs))
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
