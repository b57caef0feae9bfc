"""Builders for the per-parameter weight-quantization settings (JAX
counterpart ``ops/quant/settings.py``).

Reference: the hand-written settings dicts covering every attention
projection and FFN conv in both encoder stacks and the 3 decoder layers
(``QuantizationStudy/PostTrainingQuantization/PostTrainingQuantization.py:153-247``).
The same selection is derived from the model's parameter names by suffix,
in the port's names (flax ``attention/query/kernel`` is the port's
``attention.query.weight``).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import List

from .optim import WeightQuantSettings

# The quantized tensor families: attention q/k/v/out projection weights and
# the two FFN convs (encoder and decoder). Embeddings, distil convs and the
# output projection stay FP32.
QUANT_KERNEL_MARKERS = (
    "attention.query.weight",
    "attention.key.weight",
    "attention.value.weight",
    "attention.out.weight",
    "ffn.conv1.weight",
    "ffn.conv2.weight",
)


def quantized_param_names(params: Mapping, markers=QUANT_KERNEL_MARKERS) -> List[str]:
    """All parameter names with a quantized family's suffix, sorted."""
    # endswith also catches self_attention/cross_attention.
    return sorted(name for name in params if any(name.endswith(m) for m in markers))


def build_weight_quant_settings(params: Mapping, quant_fn: Callable,
                                markers=QUANT_KERNEL_MARKERS) -> WeightQuantSettings:
    """``WeightQuantSettings`` applying ``quant_fn(w, percentage, generator)``
    to every matched tensor."""
    names = quantized_param_names(params, markers)
    if not names:
        raise ValueError("no parameters matched the quantization markers")
    return WeightQuantSettings({name: quant_fn for name in names}, params)
