"""Quantization codebooks: Fibonacci, fibbinary (no-adjacent-ones).

The port's own copy of the JAX package's ``ops/quant/codebooks.py`` (the
builders are the same numpy code). Reference:

- Fibonacci sequence codebook: ``quant_cpu.cpp:214-231`` ``generateFibonacci``
  (scaled Fibonacci numbers ``2^-fl * fib`` up to ``2^(wl-fl-1)``, positive only).
- No-adjacent-ones / fibbinary codewords: ``quant_cpu.cpp:287-310``
  ``generateNonAdjacentOnesSequences`` (all wl-bit strings with no two adjacent
  1 bits, interpreted as non-negative ints, scaled by ``2^-fl``).
- LSQ-fibbinary codebook: ``models/InformerLSQFibbinary/LSQ.py:48-54``: the
  fibbinary generator filtered to ``bit_length() <= nbits-1`` and mirrored to
  negative values (weights are signed in LSQ space).

:func:`nearest_codeword` goes through the CUDA kernel of
``ops/cuda/quant.py`` on a CUDA tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda.quant import fused_nearest_codeword


def fibonacci_sequence_codebook(wl: int, fl: int) -> np.ndarray:
    """Scaled Fibonacci numbers (reference ``generateFibonacci``): starts with
    two ``2^-fl`` entries; grows while ``fib[-1]+fib[-2] <= 2^(wl-fl-1)``."""
    res = 2.0 ** (-fl)
    limit = 2.0 ** (wl - fl - 1)
    seq = [res, res]
    while seq[-1] + seq[-2] <= limit:
        seq.append(seq[-1] + seq[-2])
    return np.unique(np.asarray(seq, dtype=np.float64))


def fibbinary_ints(max_bits: int) -> np.ndarray:
    """All non-negative integers representable in ``max_bits`` bits with no two
    adjacent 1 bits (the 'fibbinary' numbers), ascending (the bit-trick
    generator of ``models/InformerLSQFibbinary/LSQ.py:48-54``)."""
    out = []
    x = 0
    while x < (1 << max_bits):
        out.append(x)
        y = ~(x >> 1)
        x = (x - y) & y
    return np.asarray(out, dtype=np.int64)


def fibbinary_codebook(wl: int, fl: int) -> np.ndarray:
    """Non-negative fibbinary codewords of ``wl`` bits scaled by ``2^-fl``
    (reference ``noAdjecentOnes`` / QAT-Fibonacci codebook)."""
    ints = fibbinary_ints(wl).astype(np.float64)
    return ints / (1 << fl) if fl >= 0 else ints * (1 << -fl)


def lsq_fibbinary_codebook(nbits: int) -> np.ndarray:
    """Signed LSQ codebook: fibbinary ints with ``bit_length() <= nbits - 1``,
    mirrored to negative (reference ``models/InformerLSQFibbinary/LSQ.py:93-105``)."""
    pos = [int(v) for v in fibbinary_ints(max(nbits - 1, 1)) if int(v).bit_length() <= nbits - 1]
    vals = sorted(set([-v for v in pos] + pos))
    return np.asarray(vals, dtype=np.float64)


def nearest_codeword(x: torch.Tensor, codebook) -> torch.Tensor:
    """Snap each element of ``x`` to its nearest codebook entry, ties to the
    lower-index codeword (JAX ``codebooks.py:nearest_codeword``).
    ``codebook`` is an array, converted to ``x``'s dtype on ``x``'s device,
    or such a tensor already there (as ``DenseLSQ`` keeps it)."""
    if not isinstance(codebook, torch.Tensor):
        codebook = torch.as_tensor(np.asarray(codebook), dtype=x.dtype, device=x.device)
    return fused_nearest_codeword(x, codebook)
