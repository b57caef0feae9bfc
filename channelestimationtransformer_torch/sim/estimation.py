"""LS channel estimation and LMMSE equalization (JAX counterpart
``sim/estimation.py``).

Reference: Sionna's ``LSChannelEstimator`` and ``LMMSEEqualizer`` as
configured in ``MimoSimulation/KerasFullSimulation.py:200-241``.
"""

from __future__ import annotations

import torch

from ..core.runtime import full_f32_matmul


def ls_estimate(y_pilot: torch.Tensor, x_pilot: torch.Tensor) -> torch.Tensor:
    """Least-squares estimate from known pilots: ``h_hat = y / x`` per
    pilot-carrying resource element. Shapes broadcast; ``x_pilot`` nonzero."""
    return y_pilot / x_pilot


def lmmse_equalize(y: torch.Tensor, h: torch.Tensor, noise_var) -> torch.Tensor:
    """LMMSE equalizer for ``y [..., n_rx]`` received over ``h [..., n_rx,
    n_streams]``: ``x_hat = (H^H H + sigma^2 I)^-1 H^H y``. Batched over the
    leading axes (JAX ``vmap``s it)."""
    hh = h.transpose(-1, -2).conj()
    n_s = h.shape[-1]
    with full_f32_matmul():
        gram = hh @ h + noise_var * torch.eye(n_s, dtype=h.dtype, device=h.device)
        rhs = (hh @ y[..., None])[..., 0]
        return torch.linalg.solve(gram, rhs[..., None])[..., 0]
