"""Per-parameter weight quantization, the ``OptimLP`` weight transform
(JAX counterpart ``ops/quant/optim.py``; reference
``FullPrecision/qtorch/optim/optim_low.py:7-167``).

A :class:`WeightQuantSettings` maps parameter names (``state_dict`` /
``named_parameters`` names) to ``fn(w, percentage, generator) -> w`` and
is validated against the model's names, as OptimLP validates against
``named_parameters`` (``optim_low.py:57-73``). :func:`apply_weight_quant`
applies it and returns new tensors; the caller's tensors are left as they
are, so a sweep can quantize the same FP32 weights again at its next point.

Grouping. Names whose ``fn`` is one :class:`FixedPointWeightQuant` (equal
values count as one) are quantized together by its ``many``: one kernel
launch for the flagship's 72 tensors, as the TPU kernel's one pass over all
the weights. Any other ``fn`` goes tensor by tensor.

Random draws. JAX folds ``hash(name)`` into its key per tensor, which
changes from process to process. Here the configured tensors are visited in
sorted-name order with one ``torch.Generator``: a stochastic closure that
draws from it (``fixed_point_quantize``) draws one seed per tensor in that
order; after them each group draws one seed, its tensors taking Philox
streams 0, 1, ... in name order. The same in every run.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch

from .functional import FixedPointWeightQuant


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
    ``load_state_dict`` when ``params`` was a ``state_dict``. The other
    ``fn`` run first, then each :class:`FixedPointWeightQuant` group, in the
    order of its first name."""
    out = dict(params)
    groups = {}
    for name in sorted(settings.settings):
        fn = settings.settings[name]
        if isinstance(fn, FixedPointWeightQuant):
            groups.setdefault(fn, []).append(name)
        else:
            out[name] = fn(params[name], percentage, generator)
    for fn, names in groups.items():
        out.update(zip(names, fn.many([params[n] for n in names], generator)))
    return out
