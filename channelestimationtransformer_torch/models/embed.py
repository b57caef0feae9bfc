"""Input embeddings: circular-conv token embedding + sinusoidal positions
(reference ``models/Informer/embed.py``; JAX counterpart ``models/embed.py``).

Activations stay in the JAX package's ``[B, L, C]`` layout at every public
function. Conv weights are torch's ``[C_out, C_in, K]``; the JAX kernels are
``[K, C_in, C_out]`` (``utils/convert.py`` transposes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import variance_scaling_


def sinusoid_position_encoding(length: int, d_model: int, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """Interleaved sin/cos table ``[length, d_model]``, built in float64 numpy
    and then cast, as the JAX package builds it."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((length, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.as_tensor(pe, dtype=dtype, device=device)


def circular_conv1d(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """1D conv with circular padding on ``[B, L, C_in]`` activations;
    ``weight`` ``[C_out, C_in, K]``. Equals torch's
    ``Conv1d(padding=K//2, padding_mode='circular')``."""
    pad = weight.shape[-1] // 2
    xt = F.pad(x.transpose(1, 2), (pad, pad), mode="circular")
    return F.conv1d(xt, weight, bias).transpose(1, 2)


class TokenEmbedding(nn.Module):
    """Circular Conv1d ``c_in -> d_model`` (k=3, **no bias**), kaiming-normal init."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_model, c_in, 3))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        variance_scaling_(self.weight, 2.0, generator=generator)

    def forward(self, x):
        return circular_conv1d(x, self.weight)


class DataEmbedding(nn.Module):
    """Token conv embedding + sinusoid positions (the reference's unused
    ``x_mark`` path is dropped, as in the JAX package)."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.token = TokenEmbedding(c_in, d_model)

    def forward(self, x):
        pe = sinusoid_position_encoding(x.shape[-2], self.d_model, dtype=x.dtype,
                                        device=x.device)
        return self.token(x) + pe
