"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ctypes.

The library is built at first use from the sources under ``csrc/`` into
``build/`` beside this file (listed in .gitignore), named by a hash of the
sources, headers and flags, so an edited source rebuilds and an unchanged one
loads from disk. Each ``*.cu`` compiles to an object in its own ``nvcc``
process, all started together, and one more links them. Nothing here runs
at import time.
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
              "-Xcompiler", "-fPIC"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures in csrc/fused_step.cu, head_topk.cu, fused_block.cu, fused_tail.cu,
# conv_epilogue.cu, ssm_step.cu, conv1x1_epilogue.cu
SIGNATURES = {
    "adaptive_cell_launch": [_I] + [_P] * 24 + [_I] * 8 + [_P],
    "head_argmax_launch": [_I] + [_P] * 8 + [_I] * 6 + [_P],
    "head_topk_launch": [_I] + [_P] * 11 + [_I] * 8 + [_P],
    "bottleneck_block_launch": [_P] * 11 + [_F] * 4 + [_I] * 11 + [_P],
    "tail_conv1_launch": [_P] * 10 + [_F] * 3 + [_I] * 9 + [_P],
    "folded_epilogue_launch": [_I] + [_P] * 4 + [_L, _I, _P],
    "ssm_step_launch": [_I, _P, _L, _P, _L] + [_P] * 8 + [_I] * 7 + [_P],
    "conv1x1_epilogue_launch": [_P] * 6 + [_L, _I, _I, _P],
    "conv1x1_epilogue_plan": [_L, _I, _I, _I, _P],
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
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libadaptive_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; returns its path."""
    if not _sources():
        raise RuntimeError(f"no CUDA kernel sources (*.cu) under {CSRC}: the package was "
                           "installed without its csrc/ files")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(_sources(), objs)]
    failed = []
    for src, proc in zip(_sources(), procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink()
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
