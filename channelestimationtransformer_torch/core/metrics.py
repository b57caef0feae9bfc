"""NMSE metrics with the reference's exact semantics (``Utils/metrics.py``).

- ``nmse`` normalises by the power of the *target* ``x``.
- ``nmse_split`` (per horizon) normalises by the power of the *prediction*
  ``x_hat``: the reference's quirk, kept for metric parity.
"""

from __future__ import annotations

import torch


def nmse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Scalar NMSE = sum((x - x_hat)^2) / sum(x^2)."""
    return torch.sum(torch.square(x - x_hat)) / torch.sum(torch.square(x))


def nmse_split(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-horizon NMSE of ``[B, L, D]`` inputs: a length-``L`` vector,
    normalised by the prediction power ``sum(x_hat^2)``."""
    power = torch.sum(torch.square(x_hat), dim=(0, 2))
    mse = torch.sum(torch.square(x - x_hat), dim=(0, 2))
    return mse / power


def nmse_db(nmse_linear) -> torch.Tensor:
    """Linear NMSE -> dB (10*log10)."""
    return 10.0 * torch.log10(torch.as_tensor(nmse_linear))
