"""Gray-coded QAM mapping and demapping (JAX counterpart ``sim/qam.py``).

Square QAM, Gray labels per axis, unit average energy, max-log LLRs, as
the reference's Sionna ``Mapper`` / ``Demapper``
(``MimoSimulation/KerasFullSimulation.py:117-241``). The constellation is
built in numpy float64 and cast, as JAX's, so the two are equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _gray_pam_levels(bits_per_axis: int) -> np.ndarray:
    """PAM levels in Gray-code order: level[i] is the amplitude whose label is
    the Gray code of i."""
    m = 1 << bits_per_axis
    # Natural-order amplitudes -m+1, ..., -1, 1, ..., m-1 (step 2).
    amps = np.arange(-(m - 1), m, 2, dtype=np.float64)
    levels = np.empty(m)
    for label in range(m):
        # position of this label in Gray sequence = inverse gray code
        g = label
        mask = g >> 1
        while mask:
            g ^= mask
            mask >>= 1
        levels[label] = amps[g]
    return levels


def qam_constellation(order: int, device=None) -> torch.Tensor:
    """Unit-energy constellation (complex64, on ``device``, default the CPU)
    indexed by the integer symbol label (I bits = MSBs, Q bits = LSBs)."""
    bits = int(np.log2(order))
    assert 2 ** bits == order and bits % 2 == 0, "square QAM only"
    pam = _gray_pam_levels(bits // 2)
    points = (pam[:, None] + 1j * pam[None, :]).reshape(-1)
    energy = np.mean(np.abs(points) ** 2)
    return torch.as_tensor((points / np.sqrt(energy)).astype(np.complex64), device=device)


def _bit_weights(bps: int) -> list:
    return [1 << (bps - 1 - i) for i in range(bps)]


def qam_map(bits: torch.Tensor, order: int) -> torch.Tensor:
    """``[..., n*bits_per_symbol]`` bits -> ``[..., n]`` symbols."""
    bps = int(np.log2(order))
    const = qam_constellation(order, bits.device)
    b = bits.reshape(*bits.shape[:-1], -1, bps)
    weights = torch.tensor(_bit_weights(bps), dtype=b.dtype, device=b.device)
    labels = torch.sum(b * weights, dim=-1).long()
    return const[labels]


def _sq_dist(y: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """``|y - c|^2`` for every constellation point, as JAX's ``abs(.) ** 2``."""
    return torch.square(torch.abs(y[..., None] - const))


def qam_demap_hard(y: torch.Tensor, order: int) -> torch.Tensor:
    """Nearest-symbol hard decision -> bits ``[..., n*bps]``. A tie takes the
    first label (``torch.argmin`` returns the first minimum, as ``jnp.argmin``)."""
    bps = int(np.log2(order))
    labels = torch.argmin(_sq_dist(y, qam_constellation(order, y.device)), dim=-1)
    shifts = torch.tensor([bps - 1 - i for i in range(bps)], device=y.device)
    bits = (labels[..., None] >> shifts) & 1
    return bits.reshape(*y.shape[:-1], -1)


def qam_llr(y: torch.Tensor, order: int, noise_var) -> torch.Tensor:
    """Max-log LLRs per bit (positive = bit 0 more likely, Sionna convention).
    ``noise_var`` divides as a float32 tensor: CUDA divides by a Python number
    through its reciprocal."""
    bps = int(np.log2(order))
    noise_var = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    d = -_sq_dist(y, qam_constellation(order, y.device)) / noise_var  # log-metric [.., M]
    labels = np.arange(order)
    neg_inf = d.new_tensor(-np.inf)
    llrs = []
    for i in range(bps):
        bit = torch.as_tensor((labels >> (bps - 1 - i)) & 1, device=y.device)
        m0 = torch.amax(torch.where(bit == 0, d, neg_inf), dim=-1)
        m1 = torch.amax(torch.where(bit == 1, d, neg_inf), dim=-1)
        llrs.append(m0 - m1)
    return torch.stack(llrs, dim=-1).reshape(*y.shape[:-1], -1)
