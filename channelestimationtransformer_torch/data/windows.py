"""Device-resident windowed dataset (reference ``Utils/dataset.py:91-153``).

The whole dataset lives on the device in the packed-feature layout, float32
``[N, slots, F]`` with ``F = Nr*Nt*2`` (re/im pairs). A batch of windows is
drawn on the device: random sample indices and window starts from a
``torch.Generator``, a gather, then normalisation and AWGN. No host in the
loop and no per-step host-to-device copies.

The random draws (``idx``, ``starts``, ``noise``) may be injected instead,
so the port can be held to the JAX package's exact batches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.runtime import resolve_device


@dataclasses.dataclass
class WindowDataset:
    """A channel dataset ``[N, slots, F]`` (packed ri) resident on ``device``.

    ``h`` may be a numpy array or a tensor; it is moved to ``device`` as
    float32. ``device=None`` means the card, and raises when there is none.
    """

    h: torch.Tensor
    seq_len: int
    pred_len: int
    snr_db: float
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.h = torch.as_tensor(self.h, dtype=torch.float32, device=self.device)

    @property
    def length(self) -> int:
        return self.seq_len + self.pred_len

    @property
    def num_samples(self) -> int:
        return self.h.shape[0]

    @property
    def features(self) -> int:
        return self.h.shape[-1]


def _complex_rms(x: torch.Tensor) -> torch.Tensor:
    """Per-sample sqrt(mean |h|^2) over packed features: mean|h|^2 == 2*mean(x^2)."""
    return torch.sqrt(2.0 * torch.mean(torch.square(x), dim=(1, 2), keepdim=True))


def sample_windows(
    dataset: WindowDataset,
    batch_size: int,
    *,
    generator: torch.Generator | None = None,
    idx: torch.Tensor | None = None,
    starts: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw one batch of windows: ``(H, H_noise, H_seq, H_pred)`` as in the
    JAX package's ``sample_windows`` (``data/windows.py:88-130``).

    Each draw not injected comes from ``generator``, which must live on the
    dataset's device. ``noise`` is the standard-normal draw of shape
    ``[B, slots, F]`` before scaling. Order of operations as in the
    reference: normalise the whole sample, add noise scaled by the
    normalised RMS, then slice the window.
    """
    h = dataset.h
    n, slots, feat = h.shape
    length = dataset.length
    dev = h.device
    if idx is None:
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=dev)
    if starts is None:
        starts = torch.randint(0, slots - length + 1, (batch_size,),
                               generator=generator, device=dev)
    idx = torch.as_tensor(idx, device=dev, dtype=torch.long)
    starts = torch.as_tensor(starts, device=dev, dtype=torch.long)

    samples = h[idx]  # [B, slots, F]
    samples = samples / _complex_rms(samples)  # channelnorm: unit complex RMS
    if noise is None:
        noise = torch.randn(samples.shape, generator=generator, device=dev)
    noise = torch.as_tensor(noise, device=dev, dtype=samples.dtype)
    sigma = 10.0 ** (-dataset.snr_db / 10.0)
    noisy = samples + (np.sqrt(sigma / 2.0) * noise) * _complex_rms(samples)

    pos = starts[:, None] + torch.arange(length, device=dev)[None, :]
    pos = pos[:, :, None].expand(-1, -1, feat)
    h_clean = torch.gather(samples, 1, pos)
    h_noisy = torch.gather(noisy, 1, pos)
    return h_clean, h_noisy, h_noisy[:, : dataset.seq_len], h_clean[:, dataset.seq_len:]


def make_batch(
    dataset: WindowDataset,
    batch_size: int,
    label_len: int,
    **draws,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch ``(enc_in, dec_in, target)`` on the dataset's device:
    ``enc_in`` ``[B, seq_len, F]`` noisy history; ``dec_in``
    ``[B, label_len+pred_len, F]`` = the last ``label_len`` noisy slots then
    zeros; ``target`` ``[B, pred_len, F]`` clean future.

    ``draws`` are :func:`sample_windows`'s keyword arguments (``generator``
    and any injected ``idx``/``starts``/``noise``).
    """
    _, _, enc_in, target = sample_windows(dataset, batch_size, **draws)
    label = enc_in[:, enc_in.shape[1] - label_len:]
    zeros = enc_in.new_zeros((enc_in.shape[0], target.shape[1], enc_in.shape[2]))
    return enc_in, torch.cat([label, zeros], dim=1), target
