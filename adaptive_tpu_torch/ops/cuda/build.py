"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ctypes.

The library is built at first use from the sources under ``csrc/`` into
``build/`` beside this file (listed in .gitignore), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
from disk. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures in csrc/fused_step.cu
SIGNATURES = {
    "adaptive_cell_launch": [_I] + [_P] * 19 + [_I] * 5 + [_P],
    "head_argmax_launch": [_I] + [_P] * 7 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (CUDA_HOME or PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libadaptive_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
