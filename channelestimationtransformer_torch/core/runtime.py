"""Device selection, keyed random streams, matmul precision and profiler
spans for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else the card. With no card and no ``device`` this raises: the port
    never carries on on the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain CPU path explicitly")
    return torch.device("cuda")


def stream_generator(device, seed: int, *path: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, *path)``, the
    counterpart of JAX's ``fold_in`` streams: a stream is a function of its
    key alone, not of what was drawn before (a resumed run keyed by absolute
    epoch and batch replays the same draws; a dataset chunk keyed by its
    index is the same whatever ran before it)."""
    words = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(words[0]) << 32) | int(words[1]))


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for the matmuls inside, restored after: the JAX package runs
    the channel generator's einsums as float32 XLA dots, and TF32 keeps only
    10 mantissa bits. (torch's default is off too; a caller may have turned
    it on.)"""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the enclosed work as ``name`` in a
    running ``torch.profiler`` trace: a ``record_function`` range, a host
    event on the profiler's own clock, so a kernel can be tied to the span
    that was open when the host launched it. With no profiler running it
    is one shared no-op, and costs one check.

    The port's spans, all named ``cet.``: ``cet.step`` (one training step)
    holds ``cet.batch`` (windows, AWGN and decoder input), ``cet.model``
    (the model's forward), ``cet.backward`` (autograd; its kernels launch
    from autograd's device thread while the step's thread waits inside the
    span) and ``cet.optimizer`` (the schedule and the optimizer's update);
    ``cet.conv`` marks each circular convolution inside the forward, and the
    gradients of a float32 one on the card inside the backward
    (``ops/cuda/circular_conv.py``).
    Serving passes through ``cet.batch`` and ``cet.model`` alone."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN
