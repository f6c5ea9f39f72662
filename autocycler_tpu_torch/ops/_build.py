"""Builds the CUDA sources under csrc/ into shared libraries on first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by hand with
nvcc for Hopper (sm_90a) and loaded with ctypes — seconds per source, where
a build that includes PyTorch's headers takes minutes. Libraries go into the
git-ignored ``_build/`` directory beside the package, named by a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("sortnet",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output (register and shared-memory use per kernel)."""
    return _lib_path(name).with_suffix(".log")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built.
    Writes to a temporary name that is renamed into place on success, so a
    concurrent or interrupted build never leaves a partial library."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    output, _ = proc.communicate()
    log_path(name).write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{output}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every missing library, one nvcc per source, all at once."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, compiling it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
