"""End-to-end MIMO link simulation: bits -> QAM -> precode -> channel -> AWGN
-> equalize -> demap -> BER (JAX counterpart ``sim/link.py``).

Reference: ``MimoSimulation/KerasFullSimulation.py:243-317`` (Sionna: LDPC +
QAM + ZF precoding + LS/perfect CSI + LMMSE + BER) and
``MimoSimulation/Predict.py:88-135`` (the channel predictor in the loop).
The reference model's two switches are here too: ``csi="perfect"|"ls"`` and
``domain="freq"|"time"``. FEC is the JAX package's conv/Viterbi
(:mod:`.coding`) or QC-LDPC (:mod:`.ldpc`).

Each function takes a ``torch.Generator`` where JAX takes a key, on the
device it runs on. The payload bits (``bits`` / ``info``) and the unit
complex normal noise before its ``sqrt(noise_var / 2)`` scale may be
injected instead, so a test can hand the port JAX's own draws. ``device``
is where the simulation runs (default: the card; raises without one).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.runtime import full_f32_matmul, resolve_device
from .coding import K, conv_encode, viterbi_decode
from .estimation import lmmse_equalize, ls_estimate
from .ldpc import ldpc_decode, ldpc_encode, make_qc_ldpc
from .ofdm import ofdm_demodulate, ofdm_modulate
from .precoding import _as_complex, zf_precoder
from .qam import qam_demap_hard, qam_llr, qam_map


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    qam_order: int = 4
    n_streams: int = 2  # spatial streams (== UE antennas here)


def _noise_var(ebno_db, bps: int, rate: float, device) -> torch.Tensor:
    """``1 / (10^(ebno/10) * bps * rate)`` in float32 (JAX traces ``ebno_db``
    as f32; a float64 here moves every LLR by an ulp), as XLA compiles JAX's
    expression: ``/ 10`` as ``* 0.1``, the constant factors folded into one,
    and ``1 / 10^a`` as ``10^-a`` where they fold to 1."""
    ebno = torch.as_tensor(ebno_db, dtype=torch.float32, device=device)
    factor = bps * rate
    if factor == 1.0:
        return torch.pow(10.0, -(ebno * 0.1))
    return 1.0 / (torch.pow(10.0, ebno * 0.1) * factor)


def _complex_normal(shape, generator, device) -> torch.Tensor:
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im)


def _transmit(generator, x_freq: torch.Tensor, h_true: torch.Tensor, noise_var, domain: str,
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """Send ``x_freq [B, n_tx, n_sym, F]`` over ``h_true [B, n_rx, n_tx]``.

    ``domain="freq"``: per-subcarrier multiplication (the flat-channel model).
    ``domain="time"``: the reference's time branch
    (``KerasFullSimulation.py:253-276``): OFDM-modulate each symbol (CP =
    F//4), the flat channel as one tap, AWGN in the *time* domain, demodulate.
    ``noise`` is the unit complex normal draw of the received shape.

    Returns received ``[B, n_rx, n_sym, F]``.
    """
    if domain not in ("freq", "time"):
        raise ValueError(f"unknown domain {domain!r}")
    f = x_freq.shape[-1]
    cp = max(f // 4, 1)
    with full_f32_matmul():
        if domain == "freq":
            y = torch.einsum("brt,btnf->brnf", h_true, x_freq)
        else:
            y = torch.einsum("brt,btns->brns", h_true, ofdm_modulate(x_freq, cp))
    if noise is None:
        noise = _complex_normal(y.shape, generator, y.device)
    y = y + torch.sqrt(noise_var / 2) * noise.to(y.device)
    return y if domain == "freq" else ofdm_demodulate(y, f, cp)


def _receive_csi(y: torch.Tensor, h_eff: torch.Tensor, n_pilot: int, csi: str):
    """Split pilots/data and produce the receiver's effective-channel estimate.

    ``y [B, n_rx, n_pilot + n_data_sym, F]``; pilot symbol ``s`` carried
    stream ``s`` with an all-ones pilot (the reference ResourceGrid's
    ``pilot_pattern="kronecker"``), so the LS estimate is ``h_hat[..., s, f]
    = y_pilot[..., s, f] / 1`` per subcarrier.

    Returns (y_data ``[B, n_rx, n_data_sym, F]``, h_rx ``[B, F, n_rx, S]``).
    """
    f = y.shape[-1]
    if csi == "perfect":
        return y, h_eff[:, None].expand(h_eff.shape[0], f, *h_eff.shape[1:])
    if csi != "ls":
        raise ValueError(f"unknown csi {csi!r}")
    h_hat = ls_estimate(y[:, :, :n_pilot], torch.ones((), dtype=y.dtype, device=y.device))
    return y[:, :, n_pilot:], torch.movedim(h_hat, 3, 1)  # [B, F, n_rx, S]


def _pilot_symbols(p: torch.Tensor, n_streams: int) -> torch.Tensor:
    """Precoded orthogonal pilot block: symbol ``s`` sends stream ``s`` only.

    ``p [B, n_tx, S]`` -> ``[B, n_tx, S(n_sym), 1(F)]``: JAX's double
    ``swapaxes`` (``link.py:119-126``), so pilot symbol ``s`` on antenna ``t``
    is ``p[b, t, s]``.
    """
    return p.transpose(1, 2)[:, :, :, None].transpose(1, 2)


def _precode(p: torch.Tensor, syms: torch.Tensor, n_pilot: int, n_streams: int):
    """Data symbols precoded by ``p``, after ``n_pilot`` pilot symbols:
    ``[B, n_tx, n_pilot + 1, F]``."""
    with full_f32_matmul():
        x = torch.einsum("bts,bsf->btf", p, syms)[:, :, None]  # [B, n_tx, 1, F]
    if not n_pilot:
        return x
    pil = _pilot_symbols(p, n_streams).expand(p.shape[0], p.shape[1], n_pilot, syms.shape[-1])
    return torch.cat([pil, x], dim=2)


def _equalize(y, h_true, p, noise_var, cfg, num_symbols, n_pilot, csi):
    """LMMSE per subcarrier with the receiver's CSI: ``x_hat [B, S * F]``."""
    b = y.shape[0]
    with full_f32_matmul():
        h_eff = h_true @ p  # [B, n_rx, n_streams]
    y_data, h_rx = _receive_csi(y, h_eff, n_pilot, csi)
    y_f = y_data[:, :, 0].transpose(1, 2)  # [B, F, n_rx]
    x_hat = lmmse_equalize(y_f, h_rx, noise_var)  # [B, F, n_streams]
    return x_hat.transpose(1, 2).reshape(b, cfg.n_streams * num_symbols)


def _channels(h_true, h_precode, device):
    return _as_complex(h_true.to(device)), _as_complex(h_precode.to(device))


def simulate_ber(generator: torch.Generator | None, h_true: torch.Tensor,
                 h_precode: torch.Tensor, ebno_db, cfg: LinkConfig = LinkConfig(),
                 num_symbols: int = 64, csi: str = "perfect", domain: str = "freq", *,
                 bits: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                 device=None):
    """Monte-Carlo BER for a batch of channels.

    Args:
      generator: the draws not injected (bits, then the noise's real and
                 imaginary parts); on ``device``.
      h_true:    ``[B, n_rx, n_tx]`` (complex or real pairs) actual channel
                 during data transmission.
      h_precode: ``[B, n_rx, n_tx]`` channel the ZF precoder is computed from
                 (``h_true`` for perfect CSI; a predictor's output for the
                 prediction-in-the-loop BER).
      ebno_db:   per-bit SNR in dB.
      num_symbols: QAM symbols per stream per channel realization (= occupied
                 subcarriers of one OFDM data symbol).
      csi:       ``"perfect"`` genie effective channel, or ``"ls"`` least
                 squares from n_streams orthogonal pilot symbols (reference
                 ``perfect_csi`` switch, ``KerasFullSimulation.py:200-231``).
      domain:    ``"freq"`` flat per-subcarrier model or ``"time"`` OFDM
                 modulate / channel / demodulate chain.
      bits:      injected payload ``[B, n_streams * num_symbols * bps]``.
      noise:     injected unit complex normal draw of the received shape.

    Returns: (ber, bits_total): the bit error rate (a float32 tensor) and count.
    """
    device = resolve_device(device)
    h_true, h_precode = _channels(h_true, h_precode, device)
    b = h_true.shape[0]
    bps = int(np.log2(cfg.qam_order))
    n_bits = cfg.n_streams * num_symbols * bps
    n_pilot = cfg.n_streams if csi == "ls" else 0

    if bits is None:
        bits = torch.rand((b, n_bits), generator=generator, device=device) < 0.5
    bits = bits.to(device=device, dtype=torch.float32)
    # One OFDM data symbol per stream: [B, n_streams, F=num_symbols].
    syms = qam_map(bits, cfg.qam_order).reshape(b, cfg.n_streams, num_symbols)
    p = zf_precoder(h_precode)  # [B, n_tx, n_rx(=streams)]
    x = _precode(p, syms, n_pilot, cfg.n_streams)
    # Es/N0 = Eb/N0 * bps (unit-energy constellation).
    noise_var = _noise_var(ebno_db, bps, 1.0, device)
    y = _transmit(generator, x, h_true, noise_var, domain, noise)
    x_hat = _equalize(y, h_true, p, noise_var, cfg, num_symbols, n_pilot, csi)

    bits_hat = qam_demap_hard(x_hat, cfg.qam_order).reshape(b, n_bits)
    errors = torch.sum(torch.abs(bits_hat - bits))
    total = b * n_bits
    return errors / errors.new_tensor(total), total


def simulate_coded_ber(generator: torch.Generator | None, h_true: torch.Tensor,
                       h_precode: torch.Tensor, ebno_db, cfg: LinkConfig = LinkConfig(),
                       num_symbols: int = 64, fec: str = "conv", csi: str = "perfect",
                       domain: str = "freq", *, info: torch.Tensor | None = None,
                       noise: torch.Tensor | None = None, device=None):
    """Coded BER/BLER with a selectable FEC (the reference's coded link uses
    Sionna's 5G LDPC, ``MimoSimulation/KerasFullSimulation.py:139-151``):

    - ``fec="conv"``: K=7 rate-1/2 convolutional code + soft Viterbi
      (:mod:`.coding`); any payload size (zero-tail fills the frame).
    - ``fec="ldpc"``: rate-1/2 QC-LDPC (n=648) + normalized min-sum BP
      (:mod:`.ldpc`); the payload ``n_streams * num_symbols * bps`` must be a
      multiple of 648.

    One payload spans all streams/symbols of a channel realization, so BLER
    is per realization. ``info`` is the injected payload (``[B, frames, k]``
    for LDPC, ``[B, n_info]`` for conv); the rest as :func:`simulate_ber`.
    Returns (ber, bler, info_bits_total).
    """
    device = resolve_device(device)
    h_true, h_precode = _channels(h_true, h_precode, device)
    b = h_true.shape[0]
    bps = int(np.log2(cfg.qam_order))
    n_coded = cfg.n_streams * num_symbols * bps

    if fec == "ldpc":
        code = make_qc_ldpc()
        if n_coded % code.n:
            raise ValueError(f"LDPC payload {n_coded} must be a multiple of n={code.n}")
        frames = n_coded // code.n
        n_info = frames * code.k
        if info is None:
            info = torch.rand((b, frames, code.k), generator=generator, device=device) < 0.5
        info = info.to(device=device, dtype=torch.int32)
        coded = ldpc_encode(code, info).reshape(b, n_coded).float()
        info = info.reshape(b, n_info)
    else:
        n_info = n_coded // 2 - (K - 1)  # rate-1/2 + zero tail fills the frame
        if info is None:
            info = torch.rand((b, n_info), generator=generator, device=device) < 0.5
        info = info.to(device=device, dtype=torch.int32)
        coded = conv_encode(info).float()  # [B, n_coded]

    syms = qam_map(coded, cfg.qam_order).reshape(b, cfg.n_streams, num_symbols)
    p = zf_precoder(h_precode)
    n_pilot = cfg.n_streams if csi == "ls" else 0
    x = _precode(p, syms, n_pilot, cfg.n_streams)
    # Es/N0 accounts for the code rate: Eb refers to *information* bits.
    noise_var = _noise_var(ebno_db, bps, 0.5, device)
    y = _transmit(generator, x, h_true, noise_var, domain, noise)
    x_hat = _equalize(y, h_true, p, noise_var, cfg, num_symbols, n_pilot, csi)

    llr = qam_llr(x_hat[..., None], cfg.qam_order, noise_var).reshape(b, n_coded)
    if fec == "ldpc":
        decoded = ldpc_decode(code, llr.reshape(b, frames, code.n), num_iters=25)
        decoded = decoded.reshape(b, n_info)
    else:
        decoded = viterbi_decode(llr, num_bits=n_info)
    bit_errs = torch.sum(decoded != info, dim=-1)
    total = b * n_info
    ber = torch.sum(bit_errs).float() / torch.tensor(float(total), device=device)
    bler = torch.mean((bit_errs > 0).float())
    return ber, bler, total
