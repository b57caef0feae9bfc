"""NMSE metrics with the reference's exact semantics (``Utils/metrics.py``).

- ``nmse`` normalises by the power of the *target* ``x``.
- ``nmse_split`` (per horizon) normalises by the power of the *prediction*
  ``x_hat``: the reference's quirk, kept for metric parity.

A bf16 or f16 prediction against the f32 target promotes as in JAX:
``x - x_hat`` and so both results are f32, while ``nmse_split``'s power
term is a sum in the prediction's dtype (accumulated in f32, rounded to
it).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce_sum


def nmse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Scalar NMSE = sum((x - x_hat)^2) / sum(x^2)."""
    return torch.sum(torch.square(x - x_hat)) / torch.sum(torch.square(x))


def nmse_split(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-horizon NMSE of ``[B, L, D]`` inputs: a length-``L`` vector,
    normalised by the prediction power ``sum(x_hat^2)``."""
    power = torch.sum(torch.square(x_hat), dim=(0, 2))
    mse = torch.sum(torch.square(x - x_hat), dim=(0, 2))
    return mse / power


def nmse_share(x_hat: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the scalar NMSE of a batch split over the
    data-parallel ``group``: its squared error over the whole batch's target
    power (one all-reduce; the target carries no gradient). The shares, and
    their gradients, sum over the group to the whole batch's :func:`nmse`,
    the loss JAX takes of a batch-sharded input under one global jit."""
    return torch.sum(torch.square(x - x_hat)) / all_reduce_sum(torch.sum(torch.square(x)), group)


def nmse_split_global(x_hat: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """:func:`nmse_split` of the whole batch split over ``group`` (one
    all-reduce of the per-horizon sums)."""
    power = torch.sum(torch.square(x_hat), dim=(0, 2)).float()
    sums = all_reduce_sum(torch.stack([power, torch.sum(torch.square(x - x_hat), dim=(0, 2))]),
                          group)
    return sums[1] / sums[0]


def nmse_db(nmse_linear) -> torch.Tensor:
    """Linear NMSE -> dB (10*log10)."""
    return 10.0 * torch.log10(torch.as_tensor(nmse_linear))
