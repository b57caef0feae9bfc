"""ZF precoding and spectral efficiency (JAX counterpart ``sim/precoding.py``).

Reference: ``MimoSimulation/utils.py``'s ZF helpers and
``SpectralEfficiency(WIP)/NMSEvsSpectralEfficiency.py:30-67``
(``log2 det(I + SNR * H H^H)`` with ZF on estimated against actual channels).
The matmuls run in full float32 (``core/runtime.py:full_f32_matmul``): TF32
reaches complex GEMMs too.
"""

from __future__ import annotations

import math

import torch

from ..core.runtime import full_f32_matmul


def _as_complex(h: torch.Tensor) -> torch.Tensor:
    """Accept complex ``[..., nr, nt]`` or real-pair ``[..., nr, nt, 2]``
    (real pairs at the boundaries, complex inside, as in the JAX package)."""
    if h.is_complex():
        return h
    if h.shape[-1] == 2:
        return torch.complex(h[..., 0], h[..., 1])
    raise ValueError(f"expected complex or trailing real-pair, got {tuple(h.shape)}")


def _hermitian(h: torch.Tensor) -> torch.Tensor:
    return h.transpose(-1, -2).conj()


def zf_precoder(h: torch.Tensor) -> torch.Tensor:
    """Zero-forcing precoder for ``h [..., n_rx, n_tx]``: the right pseudo-
    inverse, normalized to unit total transmit power per stream set."""
    h = _as_complex(h)
    hh = _hermitian(h)
    with full_f32_matmul():
        p = hh @ torch.linalg.inv(h @ hh)  # [..., n_tx, n_rx]
    norm = torch.sqrt(torch.sum(torch.square(torch.abs(p)), dim=(-2, -1), keepdim=True))
    return p / torch.clamp_min(norm, 1e-12)


def spectral_efficiency(h: torch.Tensor, snr_linear) -> torch.Tensor:
    """``log2 det(I + SNR/Nrx * H H^H)`` bits/s/Hz for ``h [..., n_rx, n_tx]``
    (reference ``NMSEvsSpectralEfficiency.py:30-67``)."""
    h = _as_complex(h)
    n_rx = h.shape[-2]
    with full_f32_matmul():
        gram = h @ _hermitian(h)
    eye = torch.eye(n_rx, dtype=gram.dtype, device=gram.device)
    m = eye + (snr_linear / n_rx) * gram
    logdet = torch.linalg.slogdet(m).logabsdet
    return logdet / logdet.new_tensor(math.log(2.0))


def precoded_spectral_efficiency(h_true: torch.Tensor, h_est: torch.Tensor,
                                 snr_linear) -> torch.Tensor:
    """Spectral efficiency when precoding with an *estimated/predicted* channel
    but transmitting over the true one: the NMSE -> SE degradation curve the
    reference's WIP study targets."""
    p = zf_precoder(h_est)  # [..., n_tx, n_rx]
    with full_f32_matmul():
        h_eff = _as_complex(h_true) @ p  # [..., n_rx, n_rx]
    return spectral_efficiency(h_eff, snr_linear)
