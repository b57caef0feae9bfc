"""Informer decoder: masked self-attention + cross-attention + FFN
(reference ``models/Informer/decoder.py``; JAX counterpart ``models/decoder.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .attention import AttentionLayer
from .dropout import dropout
from .encoder import LN_EPS, FeedForward


class DecoderLayer(nn.Module):
    """Causal self-attention (``mix``) -> cross-attention (``mix=False``) ->
    FFN, each with a residual (dropout on the two attention outputs, JAX
    ``decoder.py:58, 78``); post-norm after each (norm1..3), or ``pre_norm``
    before each. ``lsq_nbits`` / ``lsq_fibbinary`` reach every projection
    and FFN layer (JAX ``decoder.py:34-35, 54-55, 74-75, 82-92``)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str, *,
                 mix: bool = True, use_pallas: bool = False, pre_norm: bool = False,
                 dropout: float = 0.0, lsq_nbits: int | None = None,
                 lsq_fibbinary: bool = False, **attn_kwargs):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        lsq = dict(lsq_nbits=lsq_nbits, lsq_fibbinary=lsq_fibbinary, use_pallas=use_pallas)
        self.self_attention = AttentionLayer(
            d_model, n_heads, mask_flag=True, mix=mix, dropout=dropout, **lsq, **attn_kwargs)
        self.cross_attention = AttentionLayer(
            d_model, n_heads, mask_flag=False, mix=False, dropout=dropout, **lsq,
            **attn_kwargs)
        self.ffn = FeedForward(d_model, d_ff, activation, dropout, **lsq)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def _residual(self, x, attn_out, norm, generator):
        x = x + dropout(attn_out, self.dropout, generator, self.training)
        return x if self.pre_norm else norm(x)

    def forward(self, x, cross, generator: torch.Generator | None = None):
        s_in = self.norm1(x) if self.pre_norm else x
        x = self._residual(x, self.self_attention(s_in, s_in, s_in, generator)[0],
                           self.norm1, generator)
        c_in = self.norm2(x) if self.pre_norm else x
        x = self._residual(x, self.cross_attention(c_in, cross, cross, generator)[0],
                           self.norm2, generator)
        if self.pre_norm:
            return x + self.ffn(self.norm3(x), generator)
        return self.norm3(x + self.ffn(x, generator))


class Decoder(nn.Module):
    """DecoderLayers + final LayerNorm (reference ``decoder.py:38-51``)."""

    def __init__(self, num_layers: int, d_model: int, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, **layer_kwargs))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, cross, generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, cross, generator)
        return self.norm(x)
