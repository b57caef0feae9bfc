"""Quantization: formats, codebooks, the fake-quantization ops, the PTQ and
QAT weight transforms, gradient quantization and the LSQ layers (JAX
counterpart ``ops/quant``), int8 serving and the storage-rate report.
``auto_low`` (activation quantization by forward hooks) is imported from
its module."""

from .codebooks import (
    fibbinary_codebook,
    fibbinary_ints,
    fibonacci_sequence_codebook,
    lsq_fibbinary_codebook,
    nearest_codeword,
)
from .formats import BlockFloatingPoint, FixedPoint, FloatingPoint
from .functional import (
    FibbinaryPartialWeightQuant,
    FixedPointPartialWeightQuant,
    FixedPointWeightQuant,
    block_quantize,
    fibonacci_quantize,
    fibonacci_quantize_partial,
    fixed_point_quantize,
    fixed_point_quantize_partial,
    fixed_point_quantize_with_mask,
    float_quantize,
    no_adjacent_ones_quantize,
    quantizer,
    ste,
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
from .rate import layer_rate, model_rate_report, symbol_entropy_bits
from .serving import (
    DEFAULT_EXCLUDE,
    bf16_matmul_f32,
    build_int8_table,
    int8_circular_conv_apply,
    int8_dense_apply,
    int8_dense_weight_only_apply,
    int8_matmul,
    predict_int8,
    serving_intercept,
)
from .optim import WeightQuantSettings, apply_weight_quant, assign_, quantize_grads_
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
    "FibbinaryPartialWeightQuant",
    "FixedPointPartialWeightQuant",
    "FixedPointWeightQuant",
    "block_quantize",
    "fibonacci_quantize",
    "fibonacci_quantize_partial",
    "fixed_point_quantize",
    "fixed_point_quantize_partial",
    "fixed_point_quantize_with_mask",
    "float_quantize",
    "no_adjacent_ones_quantize",
    "quantizer",
    "ste",
    "ConvLSQ",
    "DenseLSQ",
    "codebook_pass",
    "grad_scale",
    "lsq_quantize",
    "lsq_step_size_init",
    "round_pass",
    "WeightQuantSettings",
    "apply_weight_quant",
    "assign_",
    "quantize_grads_",
    "layer_rate",
    "model_rate_report",
    "symbol_entropy_bits",
    "DEFAULT_EXCLUDE",
    "bf16_matmul_f32",
    "build_int8_table",
    "int8_circular_conv_apply",
    "int8_dense_apply",
    "int8_dense_weight_only_apply",
    "int8_matmul",
    "predict_int8",
    "serving_intercept",
    "QUANT_KERNEL_MARKERS",
    "build_weight_quant_settings",
    "quantized_param_names",
]
