"""Weight-coding rate estimation, the completed ``estimateRate(WIP)`` (JAX
counterpart ``ops/quant/rate.py``, of which this is a copy over the port's
int8 table).

Reference: ``QuantizationStudy/QuantizationAwareTraining/estimateRate(WIP).py``
is a dead stub. Its intent, the storage rate of the quantized network, is
implemented here:

- fixed-rate cost: ``nbits`` per weight,
- zero-order entropy of the quantized symbol distribution (the bound any
  entropy coder reaches),
- per-layer and whole-model report with compression ratios vs float32.

The quantization scope is the int8 serving path's
(``ops/quant/serving.build_int8_table``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def symbol_entropy_bits(symbols: np.ndarray) -> float:
    """Zero-order Shannon entropy (bits/symbol) of an integer symbol array."""
    _, counts = np.unique(np.asarray(symbols).ravel(), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def layer_rate(w_q: np.ndarray, nbits: int) -> Dict[str, float]:
    """Rate numbers for one quantized weight tensor."""
    n = int(np.asarray(w_q).size)
    h = symbol_entropy_bits(w_q)
    return {
        "numel": n,
        "fixed_bits_per_weight": float(nbits),
        "entropy_bits_per_weight": h,
        "fixed_kib": n * nbits / 8 / 1024,
        "entropy_kib": n * h / 8 / 1024,
        "f32_kib": n * 4 / 1024,
        "compression_fixed": 32.0 / nbits,
        "compression_entropy": 32.0 / h if h > 0 else float("inf"),
    }


def model_rate_report(
    model,
    *,
    nbits: int = 8,
    exclude: Optional[tuple] = None,
) -> Dict[str, dict]:
    """Per-layer + total storage-rate report of ``model`` quantized (scope
    identical to the int8 serving path). Layers are keyed by their path
    joined by ``/``, as the JAX package's report keys them."""
    from .serving import DEFAULT_EXCLUDE, build_int8_table

    table = build_int8_table(
        model, nbits=nbits,
        exclude=DEFAULT_EXCLUDE if exclude is None else exclude,
    )
    report: Dict[str, dict] = {}
    tot_n = tot_fixed = tot_entropy = 0.0
    for path, entry in table.items():
        r = layer_rate(entry["w_q"].cpu().numpy().astype(np.int32), nbits)
        report[path.replace(".", "/")] = r
        tot_n += r["numel"]
        tot_fixed += r["numel"] * nbits
        tot_entropy += r["numel"] * r["entropy_bits_per_weight"]
    if tot_n:
        report["_total"] = {
            "numel": int(tot_n),
            "fixed_bits_per_weight": tot_fixed / tot_n,
            "entropy_bits_per_weight": tot_entropy / tot_n,
            "fixed_kib": tot_fixed / 8 / 1024,
            "entropy_kib": tot_entropy / 8 / 1024,
            "f32_kib": tot_n * 4 / 1024,
            "compression_fixed": 32.0 * tot_n / tot_fixed,
            "compression_entropy": (
                32.0 * tot_n / tot_entropy if tot_entropy else float("inf")
            ),
        }
    return report
