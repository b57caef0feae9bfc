"""Complex<->real packing, channel normalisation, AWGN.

JAX counterpart ``data/packing.py``; reference ``Utils/dataset.py``
(``LoadBatch:20-44``, ``real2complex:47-51``, ``noise:54-74``,
``channelnorm:77-88``). Same numeric semantics, float32 throughout.

torch has complex tensors on the card, so the complex functions stay
complex. The ri functions keep the ``[..., 2]`` (re, im) layout, which the
dataset and the model take. Every function runs where its input lies. The
noise of :func:`awgn` and :func:`ri_awgn` comes from a ``torch.Generator``
in place of the JAX key, or is injected (``noise=``) so that a test can feed
JAX's draws.
"""

from __future__ import annotations

import math

import torch


def to_ri(h: torch.Tensor) -> torch.Tensor:
    """complex ``[...]`` -> float32 ``[..., 2]`` (re, im)."""
    return torch.stack([h.real, h.imag], dim=-1).to(torch.float32)


def from_ri(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[..., 2]`` -> complex64 ``[...]``."""
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def ri_abs2(x: torch.Tensor) -> torch.Tensor:
    """|h|^2 for the ri representation: re^2 + im^2, shape ``[...]``."""
    return x[..., 0] ** 2 + x[..., 1] ** 2


def _ri_axes(axis) -> tuple:
    """Complex axes (negative, excluding the trailing ri axis) as dims of
    the ri tensor."""
    return tuple(a - 1 if a < 0 else a for a in axis)


def ri_channel_norm(x: torch.Tensor, axis=None) -> torch.Tensor:
    """:func:`channel_norm` on the ri representation. ``axis`` indexes the
    *complex* dims (negative, excluding the trailing ri axis)."""
    if axis is None:
        return x / torch.sqrt(torch.mean(ri_abs2(x)))
    power = torch.mean(ri_abs2(x), dim=_ri_axes(axis), keepdim=True)
    return x / torch.sqrt(power)[..., None]


def ri_awgn(generator: torch.Generator | None, x: torch.Tensor, snr_db: float, axis=None,
            *, noise: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`awgn` on the ri representation (same SNR convention).
    ``noise`` is the standard-normal draw of ``x``'s shape; without it the
    draw comes from ``generator`` (on ``x``'s device)."""
    sigma = 10.0 ** (-snr_db / 10.0)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    noise = math.sqrt(sigma / 2.0) * torch.as_tensor(noise, device=x.device, dtype=x.dtype)
    if axis is None:
        rms = torch.sqrt(torch.mean(ri_abs2(x)))
    else:
        rms = torch.sqrt(torch.mean(ri_abs2(x), dim=_ri_axes(axis), keepdim=True))[..., None]
    return x + noise * rms


def ri_pack(x: torch.Tensor) -> torch.Tensor:
    """ri channel ``[..., T, Nr, Nt, 2]`` -> features ``[..., T, Nr*Nt*2]``:
    a pure reshape into the LoadBatch interleaved layout."""
    *lead, t, nr, nt, two = x.shape
    return x.reshape(*lead, t, nr * nt * two)


def complex_to_real(h: torch.Tensor) -> torch.Tensor:
    """Complex ``[..., T, Nr, Nt]`` -> real features ``[..., T, Nr*Nt*2]``,
    real/imag interleaved as last-dim pairs (reference ``LoadBatch``)."""
    *lead, t, nr, nt = h.shape
    hf = h.reshape(*lead, t, nr * nt)
    packed = torch.stack([hf.real, hf.imag], dim=-1)
    return packed.reshape(*lead, t, nr * nt * 2).to(torch.float32)


def real_to_complex(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`complex_to_real` on the flattened feature dim:
    ``[..., P, N]`` real with N even -> ``[..., P, N//2]`` complex."""
    *lead, p, n = x.shape
    x2 = x.reshape(*lead, p, n // 2, 2)
    return torch.complex(x2[..., 0], x2[..., 1])


def channel_norm(h: torch.Tensor, axis=None) -> torch.Tensor:
    """Normalise by RMS magnitude: ``h / sqrt(mean(|h|^2))``. ``axis=None``
    reduces over the whole array; pass the per-sample axes when batched."""
    if axis is None:
        return h / torch.sqrt(torch.mean(torch.square(torch.abs(h))))
    return h / torch.sqrt(torch.mean(torch.square(torch.abs(h)), dim=axis, keepdim=True))


def awgn(generator: torch.Generator | None, h: torch.Tensor, snr_db: float, axis=None,
         *, noise: torch.Tensor | None = None) -> torch.Tensor:
    """Add complex white Gaussian noise at ``snr_db`` relative to signal
    power (reference convention: ``sigma = 10^(-SNR/10)``, noise
    ``sqrt(sigma/2) * (N(0,1) + jN(0,1))`` scaled by the channel's RMS).

    ``noise`` is the complex standard draw ``N(0,1) + jN(0,1)`` of ``h``'s
    shape; without it the real parts, then the imaginary parts, come from
    ``generator`` (JAX splits its key in two for them).
    """
    sigma = 10.0 ** (-snr_db / 10.0)
    if noise is None:
        re = torch.randn(h.shape, generator=generator, device=h.device)
        im = torch.randn(h.shape, generator=generator, device=h.device)
        noise = torch.complex(re, im)
    noise = math.sqrt(sigma / 2.0) * torch.as_tensor(noise, device=h.device)
    power = torch.square(torch.abs(h))
    if axis is None:
        rms = torch.sqrt(torch.mean(power))
    else:
        rms = torch.sqrt(torch.mean(power, dim=axis, keepdim=True))
    return h + noise * rms
