"""Convolutional FEC and soft Viterbi decoding for the end-to-end link (JAX
counterpart ``sim/coding.py``).

The reference's link uses Sionna's 5G LDPC
(``MimoSimulation/KerasFullSimulation.py:117-241``); the JAX package adds the
standard K=7, rate-1/2 convolutional code (generators 133/171 octal) with a
soft-input Viterbi decoder, and this module ports it. The encoder is a table
lookup over 7-bit windows. The decoder's ``lax.scan`` over time is a loop
over time here, batched over codewords (JAX's ``vmap`` is the batch axis);
each step is the same add-compare-select, so the decoded bits equal JAX's on
the same LLRs.
"""

from __future__ import annotations

import numpy as np
import torch

K = 7  # constraint length
N_STATES = 1 << (K - 1)  # 64
G = (0o133, 0o171)  # generator polynomials; newest bit = LSB of the window


def _parity_table(g: int) -> np.ndarray:
    """parity(window & g) for every 7-bit window value."""
    vals = np.arange(1 << K)
    return np.array([bin(v & g).count("1") & 1 for v in vals], dtype=np.int32)


_PARITY = np.stack([_parity_table(g) for g in G])  # [2, 128]

# Trellis tables: full = (state << 1) | bit (7 bits); next = full & 63.
_FULL = (np.arange(N_STATES)[:, None] << 1) | np.arange(2)[None, :]  # [64, 2]
_NEXT_STATE = _FULL & (N_STATES - 1)  # [64, 2]
_OUT = _PARITY[:, _FULL]  # [2, 64, 2]: coded bits (c0, c1) per (state, input)

# Per successor state s' the two incoming edges come from p0 = s' >> 1
# (decision 0) and p1 = p0 | 32 (decision 1), both consuming input bit lsb(s').
_P0 = np.arange(N_STATES) >> 1
_P1 = _P0 | (1 << (K - 2))
_B = np.arange(N_STATES) & 1


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 convolutional encoding with K-1 terminating zero-tail.

    ``bits``: int [..., n] in {0, 1}. Returns int32 [..., 2*(n + K - 1)]
    coded bits (the tail drives the register back to state 0 so the decoder
    can terminate its traceback there).
    """
    n = bits.shape[-1]
    b = bits.long()
    zeros = b.new_zeros((*b.shape[:-1], K - 1))
    padded = torch.cat([zeros, b, zeros], dim=-1)  # leading window fill, then the tail
    # window value = the trellis ``full = (state << 1) | bit``: newest bit at the
    # LSB, oldest (b_{t-6}) at bit K-1.
    weights = torch.tensor([1 << (K - 1 - i) for i in range(K)], device=b.device)
    windows = torch.stack([padded[..., i:i + n + K - 1] for i in range(K)], dim=-1)
    idx = torch.sum(windows * weights, dim=-1)  # [..., n+K-1]
    c = torch.as_tensor(_PARITY, device=b.device)[:, idx]  # [2, ..., n+K-1]
    return torch.movedim(c, 0, -1).reshape(*bits.shape[:-1], -1)


def viterbi_decode(llr: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Soft-input Viterbi decoding of :func:`conv_encode` output.

    ``llr``: float [..., 2*(num_bits + K - 1)] log-likelihood ratios with the
    convention ``llr > 0`` favors bit 0, as :func:`.qam.qam_llr`. Returns
    int32 [..., num_bits] decoded bits. A tie between the two incoming paths
    takes decision 0 (``m1 > m0`` is strict, as JAX's).
    """
    lead = llr.shape[:-1]
    steps = num_bits + K - 1
    dev = llr.device
    flat = llr.reshape(-1, steps, 2)
    # out01[s, b, c] = +1 where coded bit c is 0 (sign convention of the llr).
    out01 = torch.as_tensor(1 - 2 * np.moveaxis(_OUT, 0, -1), dtype=torch.float32, device=dev)
    # Branch metrics of every step at once: each is (+-l0 +- l1) * 0.5, one
    # rounding, as JAX's einsum over c of size 2.
    bm = (out01[..., 0] * flat[:, :, None, None, 0]
          + out01[..., 1] * flat[:, :, None, None, 1]) * 0.5  # [N, steps, 64, 2]
    p0, p1 = torch.as_tensor(_P0, device=dev), torch.as_tensor(_P1, device=dev)
    b = torch.as_tensor(_B, device=dev)
    bm0, bm1 = bm[:, :, p0, b], bm[:, :, p1, b]  # [N, steps, 64]

    pm = flat.new_full((flat.shape[0], N_STATES), -np.inf)
    pm[:, 0] = 0.0
    decisions = torch.empty(flat.shape[0], steps, N_STATES, dtype=torch.bool, device=dev)
    for t in range(steps):
        m0 = pm[:, p0] + bm0[:, t]
        m1 = pm[:, p1] + bm1[:, t]
        d = m1 > m0
        decisions[:, t] = d
        pm = torch.where(d, m1, m0)
        pm = pm - torch.amax(pm, dim=1, keepdim=True)  # renormalize (metric drift)

    # Traceback from the tail's terminal state 0.
    state = torch.zeros(flat.shape[0], 1, dtype=torch.long, device=dev)
    bits = torch.empty(flat.shape[0], steps, dtype=torch.long, device=dev)
    for t in range(steps - 1, -1, -1):
        bits[:, t] = state[:, 0] & 1
        state = (state >> 1) | (decisions[:, t].gather(1, state).long() << (K - 2))
    return bits[:, :num_bits].to(torch.int32).reshape(*lead, num_bits)


def coded_rate() -> float:
    """Effective code rate including the zero-tail."""
    return 0.5
