"""Build and load the port's CUDA kernels: `nvcc` into a shared library with
a plain C interface, loaded with ctypes.

Sources live in fisr_tpu_torch/csrc/; libraries go to build/fisr_tpu_torch/
under the repository root (listed in .gitignore), named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads at
once. A build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "ptxas_report", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fisr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": float, "ptxas": str} for the libraries built by this
# process (empty for a library found already built)
BUILD_LOG: dict = {}
_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built on this machine")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> dict:
    """Build every named kernel library that is not built yet, one `nvcc`
    per source, all started together. Returns {name: library path}."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{out}{err}")
                continue
            os.replace(tmp, todo[n])
            BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": err}
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def ptxas_report(ptxas: str) -> list:
    """(entry function, its spill line, its register line) for every kernel in
    the output of `nvcc -Xptxas -v` (BUILD_LOG[name]["ptxas"])."""
    out, entry, spills = [], "", ""
    for line in ptxas.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line
        elif "Used" in line and "registers" in line:
            out.append((entry, spills, line.split(":", 1)[1].strip()))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name` (csrc/<name>.cu), built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]
