"""Per-parameter weight quantization, the ``OptimLP`` weight transform
(JAX counterpart ``ops/quant/optim.py``; reference
``FullPrecision/qtorch/optim/optim_low.py:7-167``).

A :class:`WeightQuantSettings` maps parameter names (``state_dict`` /
``named_parameters`` names) to ``fn(w, percentage, generator) -> w`` and
is validated against the model's names, as OptimLP validates against
``named_parameters`` (``optim_low.py:57-73``). :func:`apply_weight_quant`
applies it and returns new tensors; the caller's tensors are left as they
are, so a sweep can quantize the same FP32 weights again at its next point.

Random draws. JAX folds ``hash(name)`` into its key per tensor, which
changes from process to process. Here every configured tensor is
quantized in sorted-name order with one ``torch.Generator``, so a
stochastic ``fn`` that draws from it (``fixed_point_quantize``) draws one
seed per tensor in that order, the same in every run.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch


class WeightQuantSettings:
    """Per-parameter weight-quant functions, validated against the names of
    ``params`` (a mapping of name to tensor, e.g. ``model.state_dict()``).
    Unknown names raise immediately (reference ``optim_low.py:57-73``)."""

    def __init__(self, settings: Mapping[str, Callable], params: Mapping[str, torch.Tensor]):
        unknown = set(settings) - set(params)
        if unknown:
            raise ValueError(
                f"weight_quant settings reference unknown parameters: {sorted(unknown)}")
        self.settings = dict(settings)

    def __contains__(self, name):
        return name in self.settings

    def __len__(self):
        return len(self.settings)


def apply_weight_quant(params: Mapping[str, torch.Tensor], settings: WeightQuantSettings, *,
                       percentage: float = 1.0,
                       generator: torch.Generator | None = None) -> dict:
    """``{name: fn(w, percentage, generator)}`` for every configured
    parameter, in sorted-name order, and the other tensors as they are
    (reference ``optim_low.py:109-127``). Returns a new dict, ready for
    ``load_state_dict`` when ``params`` was a ``state_dict``."""
    out = dict(params)
    for name in sorted(settings.settings):
        out[name] = settings.settings[name](params[name], percentage, generator)
    return out
