"""Dropout drawn from an explicit ``torch.Generator`` (flax ``nn.Dropout``
semantics), so a training step's masks follow from its generator's seed and
never from the global RNG."""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale kept ones by
    ``1 / (1 - rate)``; the identity in eval mode or at rate 0. Raises in
    training without a generator."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator (generator=...)")
    keep = 1.0 - rate
    return x * torch.empty_like(x).bernoulli_(keep, generator=generator).div_(keep)
