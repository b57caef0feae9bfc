"""Functional fake-quantization ops on the serving path (JAX counterpart
``ops/quant/functional.py``; reference: the vendored qtorch fork's
functional layer, ``FullPrecision/qtorch/quant/quant_function.py:269-448``).

:func:`fixed_point_quantize` is the weight transform of the
post-training-quantization sweep. It goes through the fused CUDA kernel of
``ops/cuda/quant.py`` on a CUDA tensor and through its plain version on a
CPU tensor; the plain version's helpers (``_fixed_bounds``,
``_round_to_grid``) live beside the kernel. Stochastic rounding draws one
seed from an explicit ``torch.Generator`` where JAX takes a ``key``, and
follows the kernel's 24-bit ``u`` where JAX's functional version draws
``jax.random.uniform``: parity with JAX is statistical there.
:class:`FixedPointWeightQuant` is the same transform as a value that
carries its format, so that ``apply_weight_quant`` can quantize every
tensor that shares it in one grouped launch (:meth:`~FixedPointWeightQuant.many`).

The codebook snaps :func:`fibonacci_quantize` and
:func:`no_adjacent_ones_quantize` go through the nearest-codeword kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..cuda.bd_attention import draw_seed
from ..cuda.quant import fused_fixed_point_quantize, fused_fixed_point_quantize_grouped
from .codebooks import fibbinary_codebook, fibonacci_sequence_codebook, nearest_codeword


def fixed_point_quantize(x: torch.Tensor, wl: int, fl: int, *, clamp: bool = True,
                         symmetric: bool = False, rounding: str = "nearest",
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """Fixed-point fake quantization (reference ``quant_function.py:269-298``,
    kernels ``quant_cpu.cpp:117-164``). ``rounding="stochastic"`` draws its
    seed from ``generator`` (on x's device)."""
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    seed = None
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        seed = draw_seed(generator, x.device)
    return fused_fixed_point_quantize(x, wl, fl, clamp=clamp, symmetric=symmetric,
                                      stochastic=seed is not None, seed=seed)


@dataclasses.dataclass(frozen=True)
class FixedPointWeightQuant:
    """The weight transform ``fn(w, percentage, generator)`` of one
    fixed-point format: calling it is :func:`fixed_point_quantize` of one
    tensor (``percentage`` is not read, as in the sweep's closure, JAX
    ``experiments/ptq_sweep.py:99-103``). Equal quantizers are equal values,
    so ``apply_weight_quant`` gathers the tensors that share one and
    quantizes them with one :meth:`many` call."""

    wl: int
    fl: int
    rounding: str = "nearest"
    clamp: bool = True
    symmetric: bool = False

    def __post_init__(self):
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(f"unknown rounding {self.rounding!r}")

    def __call__(self, w: torch.Tensor, percentage: float = 1.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return fixed_point_quantize(w, self.wl, self.fl, clamp=self.clamp,
                                    symmetric=self.symmetric, rounding=self.rounding,
                                    generator=generator)

    def many(self, tensors, generator: torch.Generator | None = None) -> list:
        """Every tensor of ``tensors`` (one device) quantized in one grouped
        launch per ``MAX_GROUP`` tensors; stochastic rounding draws one
        seed from ``generator`` for the group, and tensor ``t`` its Philox
        stream ``t``."""
        tensors = list(tensors)
        seed = None
        if self.rounding == "stochastic" and tensors:
            if generator is None:
                raise ValueError("stochastic rounding needs a torch.Generator")
            seed = draw_seed(generator, tensors[0].device)
        return fused_fixed_point_quantize_grouped(
            tensors, self.wl, self.fl, clamp=self.clamp, symmetric=self.symmetric,
            stochastic=seed is not None, seed=seed)


def _snap(x, cb, clamp):
    q = nearest_codeword(x, cb)
    return q.clamp(float(cb.min()), float(cb.max())) if clamp else q


def fibonacci_quantize(x: torch.Tensor, wl: int, fl: int, *, clamp: bool = True) -> torch.Tensor:
    """Snap to the scaled-Fibonacci codebook (reference
    ``fibonacci_quantize_nearest``, ``quant_cpu.cpp:243-273``; positive
    codewords only, clamp to codebook range)."""
    return _snap(x, fibonacci_sequence_codebook(wl, fl), clamp)


def no_adjacent_ones_quantize(x: torch.Tensor, wl: int, fl: int, *,
                              clamp: bool = True) -> torch.Tensor:
    """Snap to the fibbinary (no-adjacent-ones) codebook (reference
    ``noAdjecentOnes_quantize_nearest``, ``quant_cpu.cpp:313-352``)."""
    return _snap(x, fibbinary_codebook(wl, fl), clamp)
