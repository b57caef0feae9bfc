"""Informer encoder: attention layers + conv-distilling pyramid + stack
(reference ``models/Informer/encoder.py``; JAX counterpart ``models/encoder.py``).

Submodules carry the JAX package's parameter names (``layer_0``,
``distil_0``, ``encoder_0``, ...) so that ``utils/convert.py`` maps one tree
onto the other name for name.

``dtype`` is the activations' dtype (flax's ``dtype``): parameters and
BatchNorm statistics stay f32; the convs and dense layers compute in
``dtype``; both norms take their statistics and normalise in f32 with the
f32 scale and bias, and round the result to the input's dtype (flax
``normalization.py``: ``_compute_stats`` with ``force_float32_reductions``,
``_normalize``).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from ..parallel.tensor import column_parallel
from .attention import AttentionLayer, dense_layer
from .dropout import dropout
from .embed import circular_conv1d
from .init import variance_scaling_

LN_EPS = 1e-6  # flax LayerNorm; torch's default is 1e-5


def distilled_length(l: int) -> int:
    """Sequence length after one ConvLayer (maxpool k=3, s=2, p=1)."""
    return (l - 1) // 2 + 1


def activation_fn(name: str):
    # flax nn.gelu is the tanh approximation
    return (lambda x: F.gelu(x, approximate="tanh")) if name == "gelu" else F.relu


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` on the input in f32, rounded back to the input's
    dtype (flax ``nn.LayerNorm(dtype=...)``); at f32 it is ``nn.LayerNorm``.
    torch's CUDA ``layer_norm`` takes no bf16 or f16 input with f32 weights."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over ``[B, C, L]`` with flax ``nn.BatchNorm``'s
    train-mode semantics. It normalises with the batch mean and the biased
    batch variance ``E[x^2] - E[x]^2`` (clipped at 0), and it updates
    ``running_var`` with that biased variance:
    ``running = (1 - momentum) * running + momentum * batch``, momentum 0.1
    here being flax's 0.9. ``nn.BatchNorm1d`` updates ``running_var`` with
    the unbiased variance instead. Eval mode is ``nn.BatchNorm1d``'s, which
    takes a bf16 or f16 input with the f32 statistics and parameters,
    computes in f32 and returns the input's dtype. In train mode a bf16 or
    f16 input is reduced and normalised in f32 and the result rounded to its
    dtype; the statistics stay f32.

    With ``group`` set (:func:`batch_stats_group`), the batch is split over
    that data-parallel group in equal parts, and the train-mode mean and
    ``E[x^2]`` are the whole batch's: the mean over the group of each
    rank's, summed by an all-reduce that autograd sees, as flax's BatchNorm
    reduces a batch-sharded input under one global jit. With no group there
    is no collective."""

    group = None

    def forward(self, y):
        if not self.training:
            return super().forward(y)
        yf = y.float()
        mean, mean2 = yf.mean(dim=(0, 2)), torch.square(yf).mean(dim=(0, 2))
        if self.group is not None:
            both = all_reduce_sum(torch.stack([mean, mean2]), self.group)
            mean, mean2 = both / dist.get_world_size(self.group)
        var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((yf - mean[:, None]) * mul[:, None] + self.bias[:, None]).to(y.dtype)


@contextlib.contextmanager
def batch_stats_group(model: nn.Module, group):
    """Inside this block every :class:`BatchNorm` of ``model`` takes its
    train-mode statistics over the data-parallel ``group`` (``None``: each
    its own batch's, the default)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


class ConvLayer(nn.Module):
    """Distilling layer: circular conv k=3 + bias -> BatchNorm (eps 1e-5) ->
    ELU -> MaxPool(3, 2, 1), halving the sequence. The f32 weight and bias
    are cast to ``dtype`` for the conv (JAX ``encoder.py:43``); the input
    arrives in it. With ``tp_group`` set the conv runs column-parallel
    (``parallel/tensor.py``), the bias added after the gather, before the
    BatchNorm."""

    tp_group = None

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_model, d_model, 3))
        self.bias = nn.Parameter(torch.zeros(d_model))
        self.norm = BatchNorm(d_model, eps=1e-5, momentum=0.1)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        variance_scaling_(self.weight, 1.0, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if self.tp_group is not None:
            y = column_parallel(lambda x: circular_conv1d(x, w), x, self.tp_group) + b
        else:
            y = circular_conv1d(x, w, b)
        y = y.transpose(1, 2)  # [B, C, L]
        y = F.max_pool1d(F.elu(self.norm(y)), kernel_size=3, stride=2, padding=1)
        return y.transpose(1, 2)


class FeedForward(nn.Module):
    """Position-wise FFN: the reference's two k=1 convs as dense layers, with
    dropout after the activation and after ``conv2`` (JAX ``encoder.py:84-86``).
    ``lsq_nbits`` LSQ-quantizes both (JAX ``encoder.py:70-78``; reference
    ``models/InformerLSQ/encoder.py:38-39``)."""

    def __init__(self, d_model: int, d_ff: int, activation: str, dropout: float = 0.0, *,
                 lsq_nbits: int | None = None, lsq_fibbinary: bool = False,
                 use_pallas: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        lsq = dict(lsq_nbits=lsq_nbits, lsq_fibbinary=lsq_fibbinary, use_pallas=use_pallas,
                   dtype=dtype)
        self.conv1 = dense_layer(d_model, d_ff, **lsq)
        self.conv2 = dense_layer(d_ff, d_model, **lsq)
        self.act = activation_fn(activation)
        self.dropout = dropout

    def forward(self, x, generator: torch.Generator | None = None):
        y = dropout(self.act(self.conv1(x)), self.dropout, generator, self.training)
        return dropout(self.conv2(y), self.dropout, generator, self.training)


class EncoderLayer(nn.Module):
    """Self-attention + FFN. Post-norm (the reference): norm after the
    attention residual, FFN residual from the normed x, norm at the end.
    ``pre_norm``: LayerNorm before each block, plain residuals."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str, *,
                 output_attention: bool = False, use_pallas: bool = False,
                 pre_norm: bool = False, dropout: float = 0.0, lsq_nbits: int | None = None,
                 lsq_fibbinary: bool = False, dtype: torch.dtype = torch.float32,
                 **attn_kwargs):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        lsq = dict(lsq_nbits=lsq_nbits, lsq_fibbinary=lsq_fibbinary, use_pallas=use_pallas,
                   dtype=dtype)
        self.attention = AttentionLayer(
            d_model, n_heads, mask_flag=False, mix=False, output_attention=output_attention,
            dropout=dropout, **lsq, **attn_kwargs)
        self.ffn = FeedForward(d_model, d_ff, activation, dropout, **lsq)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, generator: torch.Generator | None = None):
        a_in = self.norm1(x) if self.pre_norm else x
        new_x, attn = self.attention(a_in, a_in, a_in, generator)
        # Residual dropout after attention (JAX encoder.py:132).
        x = x + dropout(new_x, self.dropout, generator, self.training)
        if self.pre_norm:
            return x + self.ffn(self.norm2(x), generator), attn
        x = self.norm1(x)
        return self.norm2(x + self.ffn(x, generator)), attn


class Encoder(nn.Module):
    """EncoderLayers with interleaved distilling ConvLayers and a final
    LayerNorm (reference ``encoder.py:57-82``)."""

    def __init__(self, num_layers: int, d_model: int, *, distil: bool = True,
                 dtype: torch.dtype = torch.float32, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.num_distil = num_layers - 1 if distil and num_layers > 1 else 0
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, dtype=dtype, **layer_kwargs))
        for i in range(self.num_distil):
            self.add_module(f"distil_{i}", ConvLayer(d_model, dtype))
        self.norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, generator: torch.Generator | None = None):
        attns = []
        for i in range(self.num_layers):
            x, attn = getattr(self, f"layer_{i}")(x, generator)
            attns.append(attn)
            if i < self.num_distil:
                x = getattr(self, f"distil_{i}")(x)
        return self.norm(x), attns


class EncoderStack(nn.Module):
    """Multi-resolution stack (reference ``encoder.py:84-99``): encoder ``i``
    reads the last ``L // 2**i`` slots; outputs concatenate on the sequence."""

    def __init__(self, e_layers: Sequence[int], d_model: int, **encoder_kwargs):
        super().__init__()
        self.num_encoders = len(e_layers)
        for i, el in enumerate(e_layers):
            self.add_module(f"encoder_{i}", Encoder(el, d_model, **encoder_kwargs))

    def forward(self, x, generator: torch.Generator | None = None):
        outs, attns = [], []
        l = x.shape[1]
        for i in range(self.num_encoders):
            x_s, attn = getattr(self, f"encoder_{i}")(x[:, l - l // 2**i:], generator)
            outs.append(x_s)
            attns.append(attn)
        return torch.cat(outs, dim=1), attns


def encoder_stack_output_length(seq_len: int, e_layers: Sequence[int], distil: bool) -> int:
    """Output length of :class:`EncoderStack` for a given input length."""
    total = 0
    for i, el in enumerate(e_layers):
        l = seq_len // (2**i)
        if distil:
            for _ in range(max(el - 1, 0)):
                l = distilled_length(l)
        total += l
    return total
