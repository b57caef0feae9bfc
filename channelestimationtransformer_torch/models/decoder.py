"""Informer decoder: masked self-attention + cross-attention + FFN
(reference ``models/Informer/decoder.py``; JAX counterpart ``models/decoder.py``)."""

from __future__ import annotations

from torch import nn

from .attention import AttentionLayer
from .encoder import LN_EPS, FeedForward


class DecoderLayer(nn.Module):
    """Causal self-attention (``mix``) -> cross-attention (``mix=False``) ->
    FFN, each with a residual; post-norm after each (norm1..3), or
    ``pre_norm`` before each."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str, *,
                 mix: bool = True, use_pallas: bool = False, pre_norm: bool = False,
                 **attn_kwargs):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attention = AttentionLayer(
            d_model, n_heads, mask_flag=True, mix=mix, use_pallas=use_pallas, **attn_kwargs)
        self.cross_attention = AttentionLayer(
            d_model, n_heads, mask_flag=False, mix=False, use_pallas=use_pallas,
            **attn_kwargs)
        self.ffn = FeedForward(d_model, d_ff, activation)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, cross):
        if self.pre_norm:
            s_in = self.norm1(x)
            x = x + self.self_attention(s_in, s_in, s_in)[0]
            x = x + self.cross_attention(self.norm2(x), cross, cross)[0]
            return x + self.ffn(self.norm3(x))
        x = self.norm1(x + self.self_attention(x, x, x)[0])
        x = self.norm2(x + self.cross_attention(x, cross, cross)[0])
        return self.norm3(x + self.ffn(x))


class Decoder(nn.Module):
    """DecoderLayers + final LayerNorm (reference ``decoder.py:38-51``)."""

    def __init__(self, num_layers: int, d_model: int, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, **layer_kwargs))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, cross):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, cross)
        return self.norm(x)
