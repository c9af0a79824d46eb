"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds into
``pytorch_distributed_tpu_torch/_build/lib<name>-<hash>.so``; the hash
covers the source, every header it includes with quotes (``#include
"x.cuh"``, looked up beside the including file, as ``nvcc`` does) and the
flags, so an edited source or header builds anew. The build
runs in the process that first launches the kernel, never at import, and a
failed build raises: there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "load_all"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "ops" / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "source on first use"
    )


def _sources(src: Path) -> list:
    """``src`` and every file it includes with quotes, transitively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [path.parent / m.decode()
                     for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str):
    src = _SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_all(names) -> None:
    """Build every missing library, one ``nvcc`` per source, all started
    together."""
    running = []
    for name in names:
        src, lib = _target(name)
        if lib.is_file():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: a process building at
        # the same time never loads a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"building {src.name} failed (nvcc exit "
                            f"{proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_all(names) -> dict:
    """The shared libraries built from ``csrc/<name>.cu`` for each name
    (the missing ones built in parallel)."""
    with _lock:
        missing = [n for n in names if n not in _loaded]
        _build_all(missing)
        for name in missing:
            _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    return load_all([name])[name]
