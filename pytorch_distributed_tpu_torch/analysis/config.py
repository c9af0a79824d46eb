"""graftlint configuration: the ``[tool.graftlint-torch]`` pyproject block,
over the port's repo defaults.

Port of ``pytorch_distributed_tpu/analysis/config.py``. The port reads its
own table, never ``[tool.graftlint]``: that one enables the JAX package's
rules, which the port does not have. With no table (the repo has none) the
port's defaults, :data:`REPO_DEFAULTS`, are the configuration. A table's
keys replace the defaults' one by one.

Python 3.10 has no ``tomllib``, so a minimal parser handles the subset
needed: ``key = <python-ish literal>`` lines (arrays may span lines)
inside the one table. Unknown keys are rejected so typos fail loudly.

Recognized keys::

    [tool.graftlint-torch]
    enable = ["host-sync-in-hot-loop", ...]   # default: all rules
    disable = ["rule-name", ...]
    exclude = ["examples", "tests"]           # path segments to skip
    known_axes = ["dp", "tp"]                 # mesh axes besides the file's
    hot_function_patterns = ["^hot_path$"]    # extends builtin patterns
    reshard_allowed_paths = ["pkg/redistribute"]  # planner-internal files
    device_step_methods = ["step"]            # methods returning card
                                              # values (trainer.step(...))
"""

from __future__ import annotations

import ast as _ast
import os
import re
from typing import Dict, List, Optional

__all__ = ["DEFAULT_EXCLUDES", "REPO_DEFAULTS", "load_config",
           "find_pyproject"]

KNOWN_KEYS = {
    "enable", "disable", "exclude", "known_axes", "hot_function_patterns",
    "reshard_allowed_paths", "device_step_methods",
}

#: directories skipped always (vendored/native trees aren't python)
DEFAULT_EXCLUDES = ("examples", "native", ".git", "build", "dist")

#: the port's configuration where no ``[tool.graftlint-torch]`` table
#: says otherwise
REPO_DEFAULTS: Dict = {
    # demo code is chatty about host syncs on purpose; tests lint
    # violation fixtures on purpose
    "exclude": ["examples", "tests"],
    # the axis names the port's meshes declare: mesh.py's callers, the
    # strategies (dp, fsdp, dcn, cp), TensorParallel (tp),
    # PipelineParallel (pp), ExpertDataParallel (ep)
    "known_axes": ["cp", "dcn", "dp", "ep", "fsdp", "pp", "tp"],
    # Trainer.step returns its metrics as 0-d tensors on the card
    "device_step_methods": ["step"],
    # the executor is the one place a transfer is issued by hand
    "reshard_allowed_paths": ["pytorch_distributed_tpu_torch/redistribute"],
}

_SECTION = re.compile(r"^\s*\[tool\.graftlint-torch\]\s*$")
_ANY_SECTION = re.compile(r"^\s*\[")
_KV = re.compile(r"^\s*([A-Za-z_][\w\-]*)\s*=\s*(.*)$")


def find_pyproject(start: str) -> Optional[str]:
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        cand = os.path.join(cur, "pyproject.toml")
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def _literal(text: str):
    text = text.strip()
    # TOML booleans -> python
    text = re.sub(r"\btrue\b", "True", text)
    text = re.sub(r"\bfalse\b", "False", text)
    return _ast.literal_eval(text)


def read_table(pyproject_path: Optional[str]) -> Dict:
    """Parse ``[tool.graftlint-torch]``; returns {} when absent."""
    if not pyproject_path or not os.path.isfile(pyproject_path):
        return {}
    with open(pyproject_path, "r", encoding="utf-8") as fh:
        lines = fh.read().splitlines()

    out: Dict = {}
    in_section = False
    i = 0
    while i < len(lines):
        line = lines[i]
        if _SECTION.match(line):
            in_section = True
            i += 1
            continue
        if in_section and _ANY_SECTION.match(line):
            break
        if in_section:
            stripped = line.split("#", 1)[0].rstrip() \
                if not line.lstrip().startswith("#") else ""
            m = _KV.match(stripped)
            if m:
                key, value = m.group(1).replace("-", "_"), m.group(2)
                # multi-line arrays: accumulate until brackets balance
                while value.count("[") > value.count("]"):
                    i += 1
                    if i >= len(lines):
                        raise ValueError(
                            f"unterminated array for {key!r} in "
                            f"{pyproject_path}"
                        )
                    value += " " + lines[i].split("#", 1)[0].strip()
                if key not in KNOWN_KEYS:
                    raise ValueError(
                        f"unknown [tool.graftlint-torch] key {key!r} — "
                        f"known: {sorted(KNOWN_KEYS)}"
                    )
                out[key] = _literal(value)
        i += 1
    return out


def load_config(pyproject_path: Optional[str]) -> Dict:
    """The repo defaults with the ``[tool.graftlint-torch]`` table of
    ``pyproject_path`` (if any) over them."""
    return {**REPO_DEFAULTS, **read_table(pyproject_path)}


def effective_excludes(config: Dict) -> List[str]:
    return list(DEFAULT_EXCLUDES) + list(config.get("exclude") or ())
