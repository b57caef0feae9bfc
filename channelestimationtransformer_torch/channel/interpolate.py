"""Temporal interpolation of channel snapshots between SRS slots (JAX
counterpart ``channel/interpolate.py``).

Reference: ``MimoSimulation/utils.py:68-90``, cubic interpolation of the
per-SRS-slot channel to per-OFDM-symbol resolution before the link
simulation applies it. Catmull-Rom cubic convolution with an integer
upsampling factor: the fractional-phase basis is a constant ``[R, 4]``
matrix, and the interpolation is one gather and one small matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import full_f32_matmul


def _catmull_rom_basis(factor: int) -> np.ndarray:
    """[factor, 4] weights over (p_{i-1}, p_i, p_{i+1}, p_{i+2}) for the
    fractional phases r/factor, r = 0..factor-1."""
    f = np.arange(factor) / factor
    f2, f3 = f * f, f * f * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return np.stack([w0, w1, w2, w3], axis=-1)


def interpolate_slots(h: torch.Tensor, factor: int, axis: int = -2) -> torch.Tensor:
    """Cubic (Catmull-Rom) upsampling along ``axis`` by integer ``factor``.

    For ``T`` input slots returns ``(T - 1) * factor + 1`` samples: the knots
    are reproduced exactly and each inter-slot gap gets ``factor - 1``
    interpolated points. Edge segments replicate the boundary sample
    (clamped Catmull-Rom).
    """
    if factor == 1:
        return h
    h = torch.movedim(h, axis, 0)
    t = h.shape[0]
    # clamped neighbours: p[-1] = p[0], p[T] = p[T-1]
    pad = torch.cat([h[:1], h, h[-1:], h[-1:]], dim=0)  # [T+3, ...]
    # segment windows: for i in 0..T-2 -> (p[i-1], p[i], p[i+1], p[i+2])
    win = torch.stack([pad[k: k + t - 1] for k in range(4)], dim=1)  # [T-1, 4, ...]
    basis = torch.as_tensor(_catmull_rom_basis(factor), dtype=h.dtype, device=h.device)
    with full_f32_matmul():
        seg = torch.einsum("rk,sk...->sr...", basis, win)  # [T-1, R, ...]
    out = seg.reshape((t - 1) * factor, *h.shape[1:])
    out = torch.cat([out, h[-1:]], dim=0)  # trailing knot
    return torch.movedim(out, 0, axis)
