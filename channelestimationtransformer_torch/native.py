"""ctypes binding of the native host library ``native/cetpu_native.cpp``
(the port's own; JAX counterpart ``channelestimationtransformer_tpu/native``).

The C++ library covers the reference's host-side native surface (quant_cpu
fixed-point and partial quantization, the fibbinary nearest-codeword search,
DataLoader-style window packing) for host paths where a device round trip
is wasteful. It is compiled with ``g++`` and ``native/Makefile``'s flags at
the first call, never at import, into the port's git-ignored build
directory (``ops/cuda/_build.py:BUILD_DIR``) with a hash of the source, the
flags and the machine in the file name; ``native/`` itself is not written.
A failed build raises at that call and every later one, with the
compiler's log; :func:`available` says whether the library builds and
loads, and nothing falls back quietly.

The functions take and return numpy arrays, with the JAX binding's
signatures (``native/__init__.py:45-121``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from .ops.cuda._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "cetpu_native.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]  # native/Makefile


def build() -> tuple[Path, str]:
    """Compile :data:`SOURCE` unless its build exists. Returns the library's
    path and the compiler's log (empty when the build was already there)."""
    sha = hashlib.sha256(SOURCE.read_bytes())
    sha.update(" ".join(CXX_FLAGS + [platform.machine(), platform.node()]).encode())
    lib = BUILD_DIR / f"libcetpu_native-{sha.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_int, c_float, c_uint64 = ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.cetpu_fixed_point_quantize_nearest.argtypes = [f32p, f32p, i64, c_int, c_int, c_int,
                                                       c_int]
    lib.cetpu_fixed_point_quantize_stochastic.argtypes = [f32p, f32p, i64, c_int, c_int, c_int,
                                                          c_int, c_uint64]
    lib.cetpu_fixed_point_quantize_partial.argtypes = [f32p, f32p, i64, c_int, c_int, c_float,
                                                       c_int, c_int, c_int]
    lib.cetpu_nearest_codeword.argtypes = [f32p, f32p, i64, f32p, i64]
    lib.cetpu_fibbinary_ints.argtypes = [c_int, i64p, i64]
    lib.cetpu_fibbinary_ints.restype = i64
    lib.cetpu_pack_windows.argtypes = [f32p, f32p, i64, i64, i64, i64, i64p, i64]
    for fn in (lib.cetpu_fixed_point_quantize_nearest, lib.cetpu_fixed_point_quantize_stochastic,
               lib.cetpu_fixed_point_quantize_partial, lib.cetpu_nearest_codeword,
               lib.cetpu_pack_windows):
        fn.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def fixed_point_quantize(x: np.ndarray, wl: int, fl: int, *, clamp=True, symmetric=False,
                         rounding="nearest", seed=0) -> np.ndarray:
    """Fixed-point fake quantization: round half-even (``nearest``) or
    ``floor(x * 2^fl + u)`` with ``u`` from ``std::mt19937_64(seed)``
    (``stochastic``), then clamp."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty_like(x)
    if rounding == "nearest":
        lib.cetpu_fixed_point_quantize_nearest(x.ravel(), out.ravel(), x.size, wl, fl,
                                               int(clamp), int(symmetric))
    else:
        lib.cetpu_fixed_point_quantize_stochastic(x.ravel(), out.ravel(), x.size, wl, fl,
                                                  int(clamp), int(symmetric), seed)
    return out


def fixed_point_quantize_partial(x: np.ndarray, percentage: float, wl: int, fl: int, *,
                                 clamp=True, symmetric=False, proximal=True) -> np.ndarray:
    """Quantize the ``percentage`` of elements closest to (``proximal``) or
    farthest from their quantized value; the rest stay as they are."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty_like(x)
    lib.cetpu_fixed_point_quantize_partial(x.ravel(), out.ravel(), x.size, wl, fl, percentage,
                                           int(clamp), int(symmetric), int(proximal))
    return out


def nearest_codeword(x: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Each element snapped to its nearest codeword, ties to the lowest index."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    cb = np.ascontiguousarray(codebook, dtype=np.float32)
    out = np.empty_like(x)
    lib.cetpu_nearest_codeword(x.ravel(), out.ravel(), x.size, cb, cb.size)
    return out


def fibbinary_ints(max_bits: int) -> np.ndarray:
    """The integers below ``2^max_bits`` with no two adjacent 1 bits, ascending."""
    lib = _load()
    cap = 1 << max(max_bits - 1, 1)
    buf = np.empty(cap + 2, dtype=np.int64)
    n = lib.cetpu_fibbinary_ints(max_bits, buf, buf.size)
    return buf[:n].copy()


def pack_windows(h: np.ndarray, starts: np.ndarray, win_len: int) -> np.ndarray:
    """complex64 ``[N, slots, nr, nt]`` and per-sample starts -> float32
    ``[N, win_len, nr*nt*2]`` in LoadBatch layout."""
    lib = _load()
    if h.dtype != np.complex64:
        raise TypeError(f"pack_windows takes complex64, not {h.dtype}")
    num, slots, nr, nt = h.shape
    interleaved = np.ascontiguousarray(h).view(np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty((num, win_len, nr * nt * 2), dtype=np.float32)
    lib.cetpu_pack_windows(interleaved.ravel(), out.ravel(), num, slots, nr, nt, starts, win_len)
    return out
