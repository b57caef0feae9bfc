"""OFDM modulation and the time-domain channel path (JAX counterpart
``sim/ofdm.py``).

Reference: ``MimoSimulation/KerasFullSimulation.py`` simulates the link in
the frequency domain (per-subcarrier multiplication) or in the time domain
(OFDMModulator -> CIR convolution -> OFDMDemodulator, around ``:243-317``).
The FFTs are unitary (``norm="ortho"``); with a cyclic prefix at least as
long as the delay spread the time-domain round trip equals the frequency-
domain model.
"""

from __future__ import annotations

import torch


def ofdm_modulate(x_freq: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Frequency-domain symbols -> CP-prefixed time-domain signal.

    ``x_freq``: complex [..., num_symbols, fft_size]. Returns complex
    [..., num_symbols, cp_len + fft_size].
    """
    x_time = torch.fft.ifft(x_freq, dim=-1, norm="ortho")
    cp = x_time[..., x_time.shape[-1] - cp_len:] if cp_len else x_time[..., :0]
    return torch.cat([cp, x_time], dim=-1)


def ofdm_demodulate(y_time: torch.Tensor, fft_size: int, cp_len: int) -> torch.Tensor:
    """Strip the cyclic prefix and return per-subcarrier symbols."""
    return torch.fft.fft(y_time[..., cp_len:cp_len + fft_size], dim=-1, norm="ortho")


def apply_time_channel(x_time: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal tapped-delay-line channel, per OFDM symbol.

    ``x_time``: complex [..., num_symbols, sym_len]; ``taps``: complex
    [..., num_taps] (broadcast over symbols). Returns the shape of
    ``x_time``; the inter-symbol tail is truncated (with ``cp_len >=
    num_taps - 1`` the CP absorbs all intra-symbol memory). A window stack
    and one contraction, as JAX's.
    """
    num_taps = taps.shape[-1]
    sym_len = x_time.shape[-1]
    pad = x_time.new_zeros((*x_time.shape[:-1], num_taps - 1))
    xp = torch.cat([pad, x_time], dim=-1)
    # windows[..., t, k] = x[t - k] (k-th delayed copy)
    windows = torch.stack(
        [xp[..., num_taps - 1 - k:num_taps - 1 - k + sym_len] for k in range(num_taps)], dim=-1)
    return torch.einsum("...stk,...k->...st", windows, taps)


def taps_to_frequency_response(taps: torch.Tensor, fft_size: int) -> torch.Tensor:
    """CIR taps -> per-subcarrier frequency response H[f] = FFT(taps)."""
    pad = taps.new_zeros((*taps.shape[:-1], fft_size - taps.shape[-1]))
    return torch.fft.fft(torch.cat([taps, pad], dim=-1), dim=-1)
