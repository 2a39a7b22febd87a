"""Build the port's native host libraries with g++ (counterpart of
adaptive_tpu/native/build.py).

``masklib.cpp`` (RLE masks) and ``jsonlib.cpp`` (the columnar COCO JSON
scanner) are copies of the JAX package's sources. Each builds at first use,
never at import, into ``build/`` beside this file (listed in .gitignore),
under a name keyed on a hash of its source and flags, as ops/cuda/build.py
names the CUDA library: an edited source rebuilds, an unchanged one loads
from disk. g++ writes to a temporary name that ``os.replace`` moves into
place, under a file lock, so processes that build at the same moment (test
workers) neither collide nor load a half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "build"
SRC = HERE / "masklib.cpp"
JSON_SRC = HERE / "jsonlib.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def _build(src: Path, force: bool) -> str:
    lib = library_path(src)
    if lib.exists() and not force:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{lib.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
    return str(lib)


def ensure_built(force: bool = False) -> str:
    """The mask library's path, built if it is not yet."""
    return _build(SRC, force)


def ensure_json_built(force: bool = False) -> str:
    """The JSON scanner's path, built if it is not yet."""
    return _build(JSON_SRC, force)
