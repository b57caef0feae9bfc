"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled for
``sm_90a`` into ``channelestimationtransformer_torch/build/`` (git-ignored)
at first use, never at import, so modules that wrap a kernel import on a
machine without ``nvcc``. The library's file name carries a hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source is
rebuilt and a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its build exists. Returns the
    library's path and ``nvcc``'s log (``-Xptxas -v``: registers, shared
    memory, spills), empty when the build was already there."""
    src = CSRC / f"{name}.cu"
    sha = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    digest = sha.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
