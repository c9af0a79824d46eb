"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``c`` of the manifest's ``workloads`` has its traffic, strategy and
correctness limits in ``cells/<c>.json``; its configuration ``k`` is the
manifest's ``configs`` entry named ``k``, whose ``file`` holds the sizes
as they are run. A cell names its driver (``drivers/<driver>.py``), and a
per-layer metric ``m`` is read by ``metrics/<m>.py``. Adding a cell, a
configuration, a metric or a kernel family adds files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def cell_file(name: str) -> dict:
    with open(HERE / "cells" / f"{name}.json") as f:
        return json.load(f)


def config_file(manifest: dict, name: str) -> dict:
    with open(ROOT / _by_name(manifest["configs"], name, "config")["file"]) as f:
        return json.load(f)


def metrics_of(manifest: dict, kind: str, cell: str) -> List[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that ``cell``
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str) -> ModuleType:
    return _module(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric_reader(name: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def kernel_families() -> Dict[str, List[str]]:
    """``{family: [regular expressions]}`` from every ``kernels/*.json``."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        with open(path) as f:
            out[path.stem] = json.load(f)["patterns"]
    return out
