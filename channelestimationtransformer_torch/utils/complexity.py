"""Model complexity: parameters and MACs (JAX counterpart
``utils/complexity.py``).

Reference: ``ComparisonLSTMvsRNNvsGRUvsTransformer/complexityAnalysis.py:73-127``
(ptflops with custom input constructors, aten backend for the transformers).

- :func:`count_params`: the trainable parameters, exactly (JAX counts
  ``variables["params"]``; BatchNorm's running statistics are buffers here
  and not counted).
- :func:`estimate_macs`: the multiply-accumulates of the matmuls and
  convolutions of one call, counted by ``torch.utils.flop_counter``
  (MACs = FLOPs / 2), and of the fused recurrent ops (``torch.lstm``,
  ``torch.gru``, ``torch.rnn_tanh``, ``torch.rnn_relu``) from their weight
  shapes, which the counter does not see: on the CPU ``torch.lstm`` runs as
  one oneDNN op, and on the card all four are one cuDNN op. So the count is
  the same on both devices. JAX's XLA ``cost_analysis`` also counts
  elementwise work (the flagship: 44,853,756 against these 43,688,704) and
  counts a ``lax.scan`` body once (hence its ``sequential_steps``); here the
  whole sequence is counted.
"""

from __future__ import annotations

import copy

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

_RNN_OPS = (torch.lstm, torch.gru, torch.rnn_tanh, torch.rnn_relu)


def count_params(model) -> int:
    """Trainable parameters of a module (or an iterable of tensors)."""
    tensors = model.parameters() if isinstance(model, torch.nn.Module) else model
    return sum(t.numel() for t in tensors if t.requires_grad)


class _RecurrentMacs(TorchFunctionMode):
    """Counts a fused recurrent op's MACs from its weights: every 2-D weight
    (input, hidden and projection matrices of each layer and direction) is
    applied once a time step and batch row. Records what the FLOP counter
    saw inside the op (its decomposition on the CPU), to be taken off."""

    def __init__(self):
        super().__init__()
        self.macs = 0
        self.seen_flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _RNN_OPS:
            return func(*args, **kwargs)
        x = args[0]
        # The weights are the op's last list argument (an LSTM's hx is a list too).
        params = [a for a in args if isinstance(a, (list, tuple))][-1]
        rows = x.numel() // x.shape[-1]  # batch x time (padded) or time steps (packed)
        self.macs += rows * sum(w.numel() for w in params if w.dim() == 2)
        with FlopCounterMode(display=False) as inner:
            out = func(*args, **kwargs)
        self.seen_flops += inner.get_total_flops()
        return out


@torch.no_grad()
def estimate_macs(fn, *example_args) -> float:
    """MACs of one call ``fn(*example_args)``: matmuls and convolutions by
    ``FlopCounterMode``, fused recurrent ops from their weight shapes. Run it
    on a plain path: the counter cannot see inside the port's CUDA kernels,
    which are called through ctypes."""
    rnn = _RecurrentMacs()
    with FlopCounterMode(display=False) as counter, rnn:
        fn(*example_args)
    return (counter.get_total_flops() - rnn.seen_flops) / 2 + rnn.macs


def plain_twin(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` in eval mode with every ``use_pallas`` switch off:
    the plain attention and quantization path, whose products are the
    kernels' own."""
    twin = copy.deepcopy(model).eval()
    for module in twin.modules():
        if getattr(module, "use_pallas", False):
            module.use_pallas = False
    return twin


def model_complexity(model: torch.nn.Module, *example_inputs) -> dict:
    """Parameters and MACs of ``model(*example_inputs)`` in eval mode, on
    its plain twin (:func:`plain_twin`), with JAX's keys (per-sample MACs =
    total / batch). JAX's ``sequential_steps`` is not needed: the recurrent
    models' whole sequence is counted (:func:`estimate_macs`)."""
    batch = example_inputs[0].shape[0]
    macs = estimate_macs(plain_twin(model), *example_inputs)
    return {
        "params": count_params(model),
        "macs_total": macs,
        "macs_per_sample": macs / batch,
    }
