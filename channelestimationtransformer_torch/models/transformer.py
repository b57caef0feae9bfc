"""Vanilla encoder-decoder Transformer baseline (JAX counterpart
``models/transformer.py``).

Reference: ``models/Transformer/`` (``build_transformer``, ``model.py:90-174``):
continuous-input conv embedding, sinusoidal positions, pre-norm residual
blocks, causal decoder, projection to ``c_out`` and the last ``pred_len``
steps returned. Its attention layers are the Informer's ``AttentionLayer``
with ``attn="full"`` and no kernel route, as in the JAX package
(``TransformerConfig`` has no ``use_pallas``): plain torch attention.
Submodules carry the flax names (``src_embed``, ``encoder_0``,
``norm_attn``, ...), so ``utils/convert.py:from_flax_transformer`` maps one
tree onto the other name for name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TransformerConfig, activation_dtype
from ..core.runtime import resolve_device
from .attention import AttentionLayer, Dense
from .dropout import dropout
from .embed import DataEmbedding
from .encoder import LN_EPS, LayerNorm
from .informer import init_weights


class PreNormBlock(nn.Module):
    """Pre-norm residual: ``x + dropout(sublayer(norm(x)))`` (reference
    ``buildingblocks.py`` ResidualConnection): self-attention (causal with
    ``causal_self``), cross-attention on ``context`` with ``cross``, then a
    relu FFN with dropout after the activation."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float, *,
                 causal_self: bool = False, cross: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.cross = cross
        self.norm_attn = LayerNorm(d_model, eps=LN_EPS)
        self.self_attention = AttentionLayer(d_model, n_heads, attn="full",
                                             mask_flag=causal_self, dropout=dropout,
                                             dtype=dtype)
        if cross:
            self.norm_cross = LayerNorm(d_model, eps=LN_EPS)
            self.cross_attention = AttentionLayer(d_model, n_heads, attn="full",
                                                  mask_flag=False, dropout=dropout,
                                                  dtype=dtype)
        self.norm_ffn = LayerNorm(d_model, eps=LN_EPS)
        self.ffn1 = Dense(d_model, d_ff, dtype=dtype)
        self.ffn2 = Dense(d_ff, d_model, dtype=dtype)

    def _drop(self, x, generator):
        return dropout(x, self.dropout, generator, self.training)

    def forward(self, x, context=None, generator: torch.Generator | None = None):
        h = self.norm_attn(x)
        x = x + self._drop(self.self_attention(h, h, h, generator)[0], generator)
        if self.cross:
            h = self.norm_cross(x)
            x = x + self._drop(self.cross_attention(h, context, context, generator)[0],
                               generator)
        h = self._drop(F.relu(self.ffn1(self.norm_ffn(x))), generator)
        return x + self._drop(self.ffn2(h), generator)


class Transformer(nn.Module):
    """``model(enc_in [B, seq, F], dec_in [B, label + pred, F]) -> [B, pred,
    c_out]``, with the Informer's forward signature, so ``Trainer`` trains
    it unchanged: in ``train()`` mode every dropout draws from ``generator``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = config
        dtype = activation_dtype(cfg.dtype)
        self.config = cfg
        self.src_embed = DataEmbedding(cfg.enc_in, cfg.d_model, cfg.dropout, dtype)
        self.tgt_embed = DataEmbedding(cfg.enc_in, cfg.d_model, cfg.dropout, dtype)
        block = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                     dropout=cfg.dropout, dtype=dtype)
        for i in range(cfg.num_encoder_layers):
            self.add_module(f"encoder_{i}", PreNormBlock(**block))
        self.encoder_norm = LayerNorm(cfg.d_model, eps=LN_EPS)
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"decoder_{i}", PreNormBlock(**block, causal_self=True, cross=True))
        self.decoder_norm = LayerNorm(cfg.d_model, eps=LN_EPS)
        self.projection = Dense(cfg.d_model, cfg.c_out, dtype=dtype)

    def forward(self, x_enc, x_dec, generator: torch.Generator | None = None):
        cfg = self.config
        if self.training and cfg.dropout > 0.0 and generator is None:
            raise ValueError("train mode with dropout > 0 needs a torch.Generator "
                             "(model(x_enc, x_dec, generator=...))")
        enc = self.src_embed(x_enc, generator)
        for i in range(cfg.num_encoder_layers):
            enc = getattr(self, f"encoder_{i}")(enc, generator=generator)
        enc = self.encoder_norm(enc)
        dec = self.tgt_embed(x_dec, generator)
        for i in range(cfg.num_decoder_layers):
            dec = getattr(self, f"decoder_{i}")(dec, enc, generator)
        dec = self.decoder_norm(dec)
        return self.projection(dec)[:, -cfg.pred_len:, :]


def build_transformer(config: TransformerConfig, *, device=None, seed: int = 0) -> Transformer:
    """A :class:`Transformer` in ``eval()`` mode on ``device`` (default: the
    card; raises without one), with flax's default initialisers drawn from
    a ``torch.Generator`` seeded by ``seed``."""
    device = resolve_device(device)
    model = Transformer(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
