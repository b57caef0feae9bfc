"""Device selection, keyed random streams and matmul precision for the port's entry points."""

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
