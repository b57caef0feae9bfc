"""Quantization: formats, codebooks, fixed-point fake quantization, the
PTQ weight transform and the LSQ layers (JAX counterpart ``ops/quant``).
Ported so far: PTQ eval, LSQ and LSQ-fibbinary eval and training."""

from .codebooks import (
    fibbinary_codebook,
    fibbinary_ints,
    fibonacci_sequence_codebook,
    lsq_fibbinary_codebook,
    nearest_codeword,
)
from .formats import BlockFloatingPoint, FixedPoint, FloatingPoint
from .functional import (
    FixedPointWeightQuant,
    fibonacci_quantize,
    fixed_point_quantize,
    no_adjacent_ones_quantize,
)
from .lsq import (
    ConvLSQ,
    DenseLSQ,
    codebook_pass,
    grad_scale,
    lsq_quantize,
    lsq_step_size_init,
    round_pass,
)
from .optim import WeightQuantSettings, apply_weight_quant
from .settings import QUANT_KERNEL_MARKERS, build_weight_quant_settings, quantized_param_names

__all__ = [
    "fibbinary_codebook",
    "fibbinary_ints",
    "fibonacci_sequence_codebook",
    "lsq_fibbinary_codebook",
    "nearest_codeword",
    "BlockFloatingPoint",
    "FixedPoint",
    "FloatingPoint",
    "FixedPointWeightQuant",
    "fibonacci_quantize",
    "fixed_point_quantize",
    "no_adjacent_ones_quantize",
    "ConvLSQ",
    "DenseLSQ",
    "codebook_pass",
    "grad_scale",
    "lsq_quantize",
    "lsq_step_size_init",
    "round_pass",
    "WeightQuantSettings",
    "apply_weight_quant",
    "QUANT_KERNEL_MARKERS",
    "build_weight_quant_settings",
    "quantized_param_names",
]
