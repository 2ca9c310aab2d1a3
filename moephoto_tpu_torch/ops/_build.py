"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain ``extern "C"``
interface; it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the repository root at first use and loaded
with ``ctypes``.  The library name carries a hash of the source and the
flags, so a stale build is never loaded, and it is written through a
temporary file and renamed, so two processes building at once never
load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(os.path.dirname(PKG), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# name -> {"seconds": build time (0.0 when a finished build was found), "log": ptxas report}
buildInfo: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def libraryPath(source: str) -> str:
    """Path of the built library for ``csrc/<source>``, keyed by content."""
    with open(os.path.join(CSRC, source), "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD, f"lib{stem}_{digest[:16]}.so")


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and return the loaded library."""
    with _lock:
        if source in _libs:
            return _libs[source]
        so = libraryPath(source)
        info = {"seconds": 0.0, "log": ""}
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            info = {"seconds": time.perf_counter() - t0, "log": proc.stderr + proc.stdout}
        buildInfo[source] = info
        _libs[source] = ctypes.CDLL(so)
        return _libs[source]
