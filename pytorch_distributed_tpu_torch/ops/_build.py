"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds into
``pytorch_distributed_tpu_torch/_build/lib<name>-<hash>.so``; the hash
covers the source and the flags, so an edited source builds anew. The build
runs in the process that first launches the kernel, never at import, and a
failed build raises: there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "ops" / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

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


def _build(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = _BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.is_file():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a process building at the
    # same time never loads a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {src.name} failed (nvcc exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_build(name)))
        return _loaded[name]
