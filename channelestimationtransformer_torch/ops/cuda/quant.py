"""Fused quantization ops: two hand-written CUDA kernels
(``csrc/fixed_point_quantize.cu``, ``csrc/nearest_codeword.cu``) and their
plain torch versions.

Replaces the TPU kernels ``ops/pallas/quant.py:_fixed_kernel`` and
``_codeword_kernel`` of the JAX package (launched by its
``fused_fixed_point_quantize`` and ``fused_nearest_codeword``):

- fixed-point fake quantization: scale by ``2^fl``, round half to even or
  stochastically (``floor(x * 2^fl + u)``, ``u`` from 24 random bits),
  divide by ``2^fl``, clamp to the format's range;
- nearest codeword: a linear scan of the codebook with strict ``<``, ties to
  the lowest index.

The TPU kernels' padding to 512 x 1024 blocks exists for the TPU's VMEM and
is not carried over; the ``.cu`` files give the bounds on an H100.

Stochastic rounding draws ``u`` from a stateless Philox4x32-10 keyed by a
seed tensor on the device (layout in ``csrc/fixed_point_quantize.cu``;
:func:`stochastic_uniform` is its plain version), so kernel and plain
version agree bit for bit. The JAX package draws ``u`` otherwise (its
kernel from the TPU's generator, its ``functional.fixed_point_quantize``
from ``jax.random.uniform``): parity with it is exact for nearest rounding
and statistical for stochastic.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise, never falling back. The kernels take float32 only. Each launch adds
one to ``fused_fixed_point_quantize.launches`` or
``fused_nearest_codeword.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bd_attention import _MASK32, philox4x32_10

FIXED_LIB = "fixed_point_quantize"
CODEWORD_LIB = "nearest_codeword"
MAX_CODEBOOK = 12288  # entries: the codeword kernel stages the codebook in 48 KB of shared memory
_PLAIN_CHUNK = 1 << 24  # distances the plain codeword version holds at once (64 MB of f32)


def _fixed_bounds(wl: int, fl: int, symmetric: bool):
    """Representable range (reference ``sim_helper.cpp:5-13``; JAX
    ``ops/quant/functional.py:_fixed_bounds``)."""
    res = 2.0 ** (-fl)
    t_min = -(2.0 ** (wl - fl - 1))
    t_max = -t_min - res
    if symmetric:
        t_min = t_min + res
    return t_min, t_max


def stochastic_uniform(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's ``u`` for elements ``0 .. n-1``: float32 in [0, 1) on
    ``seed``'s device (layout in ``csrc/fixed_point_quantize.cu``)."""
    s = seed.reshape(()).to(torch.int64)
    g = torch.arange((n + 3) // 4, device=s.device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK32, g >> 32, zero, zero, s & _MASK32, (s >> 32) & _MASK32)
    bits = torch.stack(words, dim=-1).reshape(-1)[:n] >> 8
    return bits.to(torch.float32) * 2.0**-24


def _round_to_grid(x, fl: int, stochastic: bool, seed):
    """``round(a, r, sigma)`` (reference ``sim_helper.cpp:15-21``; JAX
    ``functional.py:_round_to_grid``): scale by ``2^fl``, round, scale back."""
    scale = 2.0**fl
    scaled = x * scale
    if stochastic:
        q = torch.floor(scaled + stochastic_uniform(seed, x.numel()).view(x.shape))
    else:
        q = torch.round(scaled)  # half to even, as jnp.round
    return q / scale


def fixed_point_quantize_reference(x, wl: int, fl: int, *, clamp: bool = True,
                                   symmetric: bool = False, stochastic: bool = False,
                                   seed: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version, in x's dtype (JAX ``functional.fixed_point_quantize``
    for nearest rounding; stochastic rounding draws the kernel's ``u``)."""
    q = _round_to_grid(x, fl, stochastic, seed)
    if clamp:
        q = q.clamp(*_fixed_bounds(wl, fl, symmetric))
    return q


def nearest_codeword_reference(x, codebook: torch.Tensor) -> torch.Tensor:
    """The plain version: ``cb[argmin |x[..., None] - cb|]`` (JAX
    ``codebooks.py:nearest_codeword``; ``argmin`` takes the first minimum),
    over chunks of x so that the distances stay under 64 MB."""
    cb = codebook.to(device=x.device, dtype=x.dtype).reshape(-1)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    step = max(1, _PLAIN_CHUNK // cb.numel())
    for i in range(0, flat.numel(), step):
        out[i:i + step] = cb[torch.argmin((flat[i:i + step, None] - cb).abs(), dim=-1)]
    return out.view(x.shape)


_ARGTYPES = {
    FIXED_LIB: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    CODEWORD_LIB: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p],
}


def _lib(name):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_input(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous tensor")
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_fixed_point_quantize(x: torch.Tensor, wl: int, fl: int, *, clamp: bool = True,
                               symmetric: bool = False, stochastic: bool = False,
                               seed: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-point fake quantization of ``x`` with ``wl`` bits, ``fl`` of
    them fractional; stochastic rounding needs ``seed``, a 1-element int64
    tensor on x's device (``bd_attention.draw_seed``). CPU tensors take
    :func:`fixed_point_quantize_reference`; CUDA tensors launch the kernel
    on the current stream without synchronising, and each launch adds one
    to ``fused_fixed_point_quantize.launches``."""
    if stochastic and seed is None:
        raise ValueError("stochastic rounding needs a seed tensor (draw_seed)")
    seed = seed if stochastic else None
    if x.device.type == "cpu":
        return fixed_point_quantize_reference(x, wl, fl, clamp=clamp, symmetric=symmetric,
                                              stochastic=stochastic, seed=seed)
    stream = _check_input(x, "fused_fixed_point_quantize")
    if seed is not None and (seed.device != x.device or seed.dtype != torch.int64
                             or seed.numel() != 1):
        raise ValueError("the seed must be a 1-element int64 tensor on x's device")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    t_min, t_max = _fixed_bounds(wl, fl, symmetric)
    with torch.cuda.device(x.device):
        err = _lib(FIXED_LIB)(x.data_ptr(), out.data_ptr(), x.numel(), 2.0**fl, t_min, t_max,
                              int(bool(clamp)), None if seed is None else seed.data_ptr(),
                              stream)
    if err != 0:
        raise RuntimeError(f"fixed_point_quantize launch failed: cudaError {err}")
    fused_fixed_point_quantize.launches += 1
    return out


fused_fixed_point_quantize.launches = 0


def fused_nearest_codeword(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Each element of ``x`` snapped to its nearest entry of ``codebook``
    (any order, ties to the lowest index). CPU tensors take
    :func:`nearest_codeword_reference`; CUDA tensors launch the kernel, with
    ``codebook`` a float32 tensor on x's device, and each launch adds one to
    ``fused_nearest_codeword.launches``."""
    if x.device.type == "cpu":
        return nearest_codeword_reference(x, codebook)
    stream = _check_input(x, "fused_nearest_codeword")
    if codebook.dtype != torch.float32:
        raise TypeError(f"fused_nearest_codeword kernel takes a float32 codebook, not "
                        f"{codebook.dtype}")
    if codebook.device != x.device or not 0 < codebook.numel() <= MAX_CODEBOOK:
        raise ValueError(f"the codebook must lie on x's device and hold 1 to {MAX_CODEBOOK} "
                         f"entries; got {codebook.numel()} on {codebook.device}")
    cb = codebook.reshape(-1).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib(CODEWORD_LIB)(x.data_ptr(), cb.data_ptr(), out.data_ptr(), x.numel(),
                                 cb.numel(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_codeword launch failed: cudaError {err}")
    fused_nearest_codeword.launches += 1
    return out


fused_nearest_codeword.launches = 0
