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

from ..core.runtime import span
from ..ops.cuda import circular_conv
from ..parallel.tensor import column_parallel
from .dropout import dropout
from .init import variance_scaling_

# Positions past the window that ``DataEmbedding``'s ``position_offset``
# may reach (JAX ``embed.py:97``).
POSITION_SPAN = 8192


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
    ``Conv1d(padding=K//2, padding_mode='circular')``.

    Three taps in float32 on the card take the kernels of
    ``ops/cuda/circular_conv.py``. Everything else, the CPU, bf16 and f16,
    and any other K, takes a circular pad and ``F.conv1d`` (cuDNN on the
    card)."""
    with span("cet.conv"):
        if (x.is_cuda and x.dtype == torch.float32
                and weight.shape[-1] == circular_conv.TAPS):
            return circular_conv.circular_conv1d(x, weight, bias)
        pad = weight.shape[-1] // 2
        xt = F.pad(x.transpose(1, 2), (pad, pad), mode="circular")
        return F.conv1d(xt, weight, bias).transpose(1, 2)


class TokenEmbedding(nn.Module):
    """Circular Conv1d ``c_in -> d_model`` (k=3, **no bias**), kaiming-normal
    init; x and the f32 weight cast to ``dtype`` for the conv (JAX
    ``embed.py:74``). With ``tp_group`` set the conv runs column-parallel
    (``parallel/tensor.py``)."""

    tp_group = None

    def __init__(self, c_in: int, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_model, c_in, 3))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        variance_scaling_(self.weight, 2.0, generator=generator)

    def forward(self, x):
        x, w = x.to(self.compute_dtype), self.weight.to(self.compute_dtype)
        if self.tp_group is not None:
            return column_parallel(lambda x: circular_conv1d(x, w), x, self.tp_group)
        return circular_conv1d(x, w)


class DataEmbedding(nn.Module):
    """Token conv embedding + sinusoid positions, then dropout (the
    reference's unused ``x_mark`` path is dropped, as in the JAX package).

    The position table is built once per (length, dtype, device) and kept,
    as the JAX package's is constant-folded: after the first call for a key,
    ``forward`` copies nothing from the host. Everything runs in ``dtype``,
    the table included (JAX ``embed.py:94``)."""

    def __init__(self, c_in: int, d_model: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.token = TokenEmbedding(c_in, d_model, dtype)
        self._tables: dict = {}

    def position_table(self, length: int, dtype, device) -> torch.Tensor:
        key = (length, dtype, torch.device(device))
        if key not in self._tables:
            self._tables[key] = sinusoid_position_encoding(length, self.d_model, dtype=dtype,
                                                           device=device)
        return self._tables[key]

    def forward(self, x, generator: torch.Generator | None = None, position_offset=None):
        """``position_offset`` (an int or a 0-d tensor; JAX
        ``embed.py:90-102``): positions start there, a window of a
        ``length + 8192`` table. As ``lax.dynamic_slice`` does, the start is
        clamped into ``[0, 8192]``: an offset past the table reads its last
        ``length`` rows."""
        tok = self.token(x)
        length = x.shape[-2]
        if position_offset is None:
            pe = self.position_table(length, tok.dtype, x.device)
        else:
            start = min(max(int(position_offset), 0), POSITION_SPAN)
            pe = self.position_table(length + POSITION_SPAN, tok.dtype,
                                     x.device)[start:start + length]
        return dropout(tok + pe, self.dropout, generator, self.training)
