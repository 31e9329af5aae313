"""Builds the CUDA sources in ``csrc/`` at first use and loads them.

Each source becomes a shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes). The library lands in
``build/torch_kernels/`` beside the package, under a name keyed by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["load_library", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
# What nvcc printed for each library built in this process (register and
# shared-memory use per kernel from -Xptxas -v), and the seconds it took.
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    for candidate in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """Loads ``csrc/<name>.cu`` as a shared library, building it first if
    this source has not been built yet. Raises if the build fails."""
    if name in _loaded:
        return _loaded[name]
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if not target.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        start = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)
        build_log[name] = {
            "seconds": time.perf_counter() - start,
            "ptxas": proc.stderr,
        }
    _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]
