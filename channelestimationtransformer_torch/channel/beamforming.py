"""DFT codebook and beam training (JAX counterpart ``channel/beamforming.py``).

Reference: ``GenerateDatasets/getDFTCodebook.m:1-30`` (codebook) and
``GenerateDatasets/Beamforming.m:52-119`` (per-slot 64-beam power sweep,
top-4-per-slot histogram over all slots, projection onto the 4 winners).
The MATLAB triple loop (batch x slot x beam) becomes four real matmuls, two
stable sorts and a scatter-add histogram, on the ri (re/im-pair float32)
representation.

Ties: ``jax.lax.top_k`` returns equal values lowest index first, and
``torch.topk`` promises no order for them. The histogram is integer and
ties often (when the same four beams win every slot, all four count every
slot), and the order of ``selected`` is the order of the beams in the
dataset's features. So both top-k steps here are a stable descending sort
cut to its first k: equal values keep the lowest index first, on every
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.runtime import full_f32_matmul, resolve_device
from ..parallel.collectives import all_reduce_sum


def dft_codebook(num_elements: int) -> np.ndarray:
    """DFT beam codebook ``[num_elements, num_beams=num_elements]`` (complex
    NumPy, a host-side constant).

    Matches ``getDFTCodebook.m`` for a horizontal ULA (Ntv=1): beam k has
    weights ``w_s = exp(j*2*pi*(s - N/2) * k/N) / sqrt(N)``.
    """
    n = num_elements
    s = np.arange(n) - n / 2.0
    k = np.arange(n) / n
    return (np.exp(2j * np.pi * np.outer(s, k)) / np.sqrt(n)).astype(np.complex64)


def dft_codebook_ri(num_elements: int, *, device=None) -> torch.Tensor:
    """ri representation ``[S, K, 2]`` of :func:`dft_codebook` on ``device``
    (default: the card)."""
    cb = dft_codebook(num_elements)
    return torch.as_tensor(np.stack([cb.real, cb.imag], axis=-1), dtype=torch.float32,
                           device=resolve_device(device))


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values along the last dim, largest first
    and equal values lowest index first (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def beam_sweep_project(h: torch.Tensor, codebook: torch.Tensor, num_selected: int = 4):
    """Beam training + projection for a batch of channel trajectories.

    Args:
      h: float32 ri ``[B, T, U, S, 2]`` (rx antennas U, tx antennas S).
      codebook: float32 ri ``[S, num_beams, 2]`` on ``h``'s device.
      num_selected: beams kept (reference: 4).

    Returns:
      ``(h_eff, selected)``: ``h_eff`` float32 ri ``[B, T, num_selected, U, 2]``
      (the beam-projected channel, ``Beamforming.m:106-118``'s ``H_channel``
      layout) and ``selected`` int64 ``[B, num_selected]`` beam indices.

    Selection as the MATLAB: per slot, rank beams by received power
    ``sum_u |(H f)_u|^2``; take the top ``num_selected`` per slot; count how
    often each beam appears across slots; keep the ``num_selected`` most
    frequent (``Beamforming.m:68-104``), ties to the lowest index.
    """
    return _select_and_gather(*_project(h, codebook), num_selected)


def _project(h: torch.Tensor, codebook: torch.Tensor):
    """Real and imaginary parts ``[B, T, U, beams]`` of ``h``'s projection
    onto every beam, on real pairs as the JAX package forms it:
    (hr + j hi)(cr + j ci) = (hr cr - hi ci) + j (hr ci + hi cr)."""
    hr, hi = h[..., 0], h[..., 1]
    cr, ci = codebook[..., 0], codebook[..., 1]
    with full_f32_matmul():
        return (torch.matmul(hr, cr) - torch.matmul(hi, ci),
                torch.matmul(hr, ci) + torch.matmul(hi, cr))


def _select_and_gather(pr: torch.Tensor, pi: torch.Tensor, num_selected: int):
    """Rank the beams per slot by power, keep the ``num_selected`` most
    frequent winners and gather their projections (``Beamforming.m:68-118``)."""
    batch, num_beams = pr.shape[0], pr.shape[-1]
    power = torch.sum(pr**2 + pi**2, dim=2)  # [B, T, beams]
    top_per_slot = _top_k_indices(power, num_selected)  # [B, T, num_selected]

    # Histogram of per-slot winners over (slots x rank).
    flat = top_per_slot.reshape(batch, -1)  # [B, T*num_selected]
    counts = torch.zeros((batch, num_beams), dtype=torch.int32, device=pr.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    selected = _top_k_indices(counts, num_selected)  # [B, num_selected]

    # Gather the winners' projections: [B, T, U, beams] -> [B, T, U, sel].
    index = selected[:, None, None, :].expand(*pr.shape[:3], num_selected)
    h_eff = torch.stack([torch.gather(pr, 3, index), torch.gather(pi, 3, index)], dim=-1)
    return h_eff.transpose(2, 3), selected  # [B, T, sel, U, 2]


def beam_sweep_project_sharded(h: torch.Tensor, codebook: torch.Tensor, num_selected: int,
                               mesh, *, axis_name: str = "model"):
    """:func:`beam_sweep_project` with the TX-antenna axis ``S`` sharded over
    ``mesh``'s ``axis_name`` axis (JAX ``beam_sweep_project_sharded``).

    Every rank holds the whole ``h`` and ``codebook``; it projects its
    contiguous shard of the antennas, and one all-reduce of the two partial
    projections completes them. The ranking, histogram and gather then run
    replicated (they are tiny). Equal to the unsharded sweep up to the
    order of the antenna sums; returns the same on every rank."""
    group = mesh.get_group(axis_name)
    p, r = dist.get_world_size(group), dist.get_rank(group)
    s = h.shape[3]
    if s % p:
        raise ValueError(f"{s} antennas not divisible by the {axis_name!r} axis size {p}")
    mine = slice(r * s // p, (r + 1) * s // p)
    pr, pi = all_reduce_sum(torch.stack(_project(h[..., mine, :], codebook[mine])), group)
    return _select_and_gather(pr, pi, num_selected)


def standardize_time_series(h_eff: torch.Tensor) -> torch.Tensor:
    """Per-(beam, rx) complex z-score over the slot axis (axis 1), on the ri
    representation: subtract the complex mean, divide by the N-1-normalised
    complex std (MATLAB ``normalize(H_channel_batch)``, ``Beamforming.m:119``)."""
    mean = torch.mean(h_eff, dim=1, keepdim=True)  # complex mean == per-channel
    centered = h_eff - mean
    var = torch.sum(centered[..., 0] ** 2 + centered[..., 1] ** 2, dim=1,
                    keepdim=True) / (h_eff.shape[1] - 1)
    return centered / torch.sqrt(var)[..., None]
