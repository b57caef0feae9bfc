"""Flax's default initialisers, so a freshly built port model draws weights
from the same distributions as the JAX package's (the values differ: the
draws come from a ``torch.Generator``)."""

from __future__ import annotations

import math

import torch
from torch import nn

# Flax's truncated normal is cut at 2 std and rescaled to keep its variance.
_TRUNC_STD = 0.87962566103423978


def fan_in(weight: torch.Tensor) -> int:
    """Fan-in of a torch ``Linear`` ``[out, in]`` or ``Conv1d`` ``[out, in, K]`` weight."""
    return weight[0].numel()


@torch.no_grad()
def variance_scaling_(weight: torch.Tensor, scale: float, generator=None) -> torch.Tensor:
    """Flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    ``lecun_normal`` at scale 1, ``kaiming_normal`` at scale 2."""
    std = math.sqrt(scale / fan_in(weight)) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def dense_(linear: nn.Linear, generator=None) -> None:
    """Flax ``nn.Dense`` defaults: lecun-normal kernel, zero bias."""
    variance_scaling_(linear.weight, 1.0, generator=generator)
    nn.init.zeros_(linear.bias)
