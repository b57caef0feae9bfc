"""Automatic activation quantization, the ``auto_low`` equivalent (JAX
counterpart ``ops/quant/auto_low.py``; reference
``FullPrecision/qtorch/auto_low/auto_low.py:132-212``: walk a torch model
and append a ``Quantizer`` after every layer of the selected types).

JAX intercepts the modules' calls with ``nn.intercept_methods``; here a
context manager registers a global forward hook (any module of the selected
types, in any model called inside the context, has its output quantized)
and removes it on exit. The models are not changed.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable

import torch
from torch import nn

from ...models.attention import Dense


class Quantizer(nn.Module):
    """Module wrapper around a quantization function, the qtorch
    ``Quantizer`` (reference ``quant_module.py:9-23``)."""

    def __init__(self, quant_fn: Callable):
        super().__init__()
        self.quant_fn = quant_fn

    def forward(self, x):
        return self.quant_fn(x)


@contextlib.contextmanager
def quantize_activations(quant_fn: Callable, layer_types: tuple = (Dense,)):
    """Inside the context, the output of every module of ``layer_types``
    (by default the port's ``Dense``, flax ``nn.Dense``'s counterpart: the
    attention projections, the FFN layers and the output projection) goes
    through ``quant_fn``; a layer returning a tuple has its first element
    quantized (the ``sequential_lower`` behaviour, reference
    ``auto_low.py:171-212``)::

        q = quantizer(forward_number=FixedPoint(8, 4))
        with quantize_activations(q):
            out = model(x_enc, x_dec)
    """

    def hook(module, args, out):
        if isinstance(module, layer_types):
            if isinstance(out, tuple):
                return (quant_fn(out[0]), *out[1:])
            if isinstance(out, torch.Tensor):
                return quant_fn(out)
        return None

    handle = nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()
