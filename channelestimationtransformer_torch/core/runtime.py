"""Device selection for the port's entry points."""

from __future__ import annotations

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
