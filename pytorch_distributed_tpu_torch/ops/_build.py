"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds into
``pytorch_distributed_tpu_torch/_build/lib<name>-<hash>.so``; the hash
covers the source, every header it includes with quotes (``#include
"x.cuh"``, looked up beside the including file, as ``nvcc`` does) and the
flags, so an edited source or header builds anew. The build
runs in the process that first launches the kernel, never at import, and a
failed build raises: there is no fallback to a plain version.

Host C++ with a plain C interface (``observability/csrc/<name>.cpp``, the
flight recorder) takes the same route through ``g++`` (``host=True``,
the reference's flags: ``-std=c++17 -O2 -shared -fPIC -pthread``).
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
_HOST_SRC_DIR = _PKG / "observability" / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

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


def _target(name: str, host: bool = False):
    src = (_HOST_SRC_DIR / f"{name}.cpp" if host
           else _SRC_DIR / f"{name}.cu")
    h = hashlib.sha256(" ".join(HOST_FLAGS if host else NVCC_FLAGS).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_all(names, host: bool = False) -> None:
    """Build every missing library, one compiler (``nvcc``, or ``g++`` for
    ``host``) per source, all started together."""
    running = []
    for name in names:
        src, lib = _target(name, host)
        if lib.is_file():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: a process building at
        # the same time never loads a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ([shutil.which("g++") or "g++", *HOST_FLAGS] if host
               else [_nvcc(), *NVCC_FLAGS]) + ["-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc, cmd[0]))
    failures = []
    for src, lib, tmp, proc, compiler in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"building {src.name} failed "
                            f"({Path(compiler).name} exit {proc.returncode})"
                            f":\n{out}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_all(names, host: bool = False) -> dict:
    """The shared libraries built from ``csrc/<name>.cu`` (or, for
    ``host``, ``observability/csrc/<name>.cpp``) for each name (the missing
    ones built in parallel)."""
    with _lock:
        missing = [n for n in names if (host, n) not in _loaded]
        _build_all(missing, host)
        for name in missing:
            _loaded[host, name] = ctypes.CDLL(str(_target(name, host)[1]))
        return {n: _loaded[host, n] for n in names}


def load(name: str, host: bool = False) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (or the host source,
    for ``host``), built if needed."""
    return load_all([name], host)[name]
