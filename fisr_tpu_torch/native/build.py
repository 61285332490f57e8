"""Build and load the port's host runtime: `g++` compiles csrc/native.cc
and csrc/zstd.cc into one shared library with a plain C interface, loaded
with ctypes.

The library goes to build/fisr_tpu_torch/ under the repository root (listed
in .gitignore), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. It is built at first use, never
at import, under a temporary name renamed into place, so processes that
build at once do not meet. A failed build raises with the compiler's output:
nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from fisr_tpu_torch.kernels.build import BUILD_DIR

__all__ = ["SOURCE", "EXTRA_SOURCES", "CXX_FLAGS", "LIBS", "target", "build", "load",
           "BUILD_LOG"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "native.cc"
# compiled into the library beside SOURCE (the zstd decoder)
EXTRA_SOURCES = (SOURCE.parent / "zstd.cc",)
# -ffp-contract=off: the colour sums stay separate multiplies and adds, so
# their bits do not depend on the host's -march (no FMA contraction)
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]
LIBS = ["-lz"]

# {"seconds": float, "path": str} once this process has built the library
BUILD_LOG: dict = {}
_LOCK = threading.Lock()
_LIB: list = []  # the loaded library, once


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the host runtime "
                           "(fisr_tpu_torch/csrc/native.cc) cannot be built on this machine")
    return path


def target(source: Path = SOURCE) -> Path:
    """The library path for `source` (with EXTRA_SOURCES) under the current
    flags."""
    h = hashlib.sha256(b"".join(p.read_bytes() for p in (source, *EXTRA_SOURCES))
                       + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` and EXTRA_SOURCES unless their library is built
    already; returns the path."""
    out = target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.name + ".", suffix=".tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(source),
                               *map(str, EXTRA_SOURCES), *LIBS],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed for {source.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=str(out))
    return out


def load() -> ctypes.CDLL:
    """The host runtime, built at first use (once a process, thread-safe)."""
    with _LOCK:
        if not _LIB:
            _LIB.append(ctypes.CDLL(str(build())))
        return _LIB[0]
