"""Informer and InformerStack, the flagship channel predictors (reference
``models/Informer/model.py``; JAX counterpart ``models/informer.py``).

Forward contract: ``model(enc_in [B, seq_len, F], dec_in [B, label_len +
pred_len, F]) -> pred [B, pred_len, c_out]`` (plus attention maps with
``output_attention``). This slice of the port serves: the models run in
``eval()`` mode only (training, with dropout and BatchNorm statistics, is
the next slice).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import InformerConfig
from ..core.runtime import resolve_device
from .decoder import Decoder
from .embed import DataEmbedding, TokenEmbedding
from .encoder import ConvLayer, Encoder, EncoderStack
from .init import dense_


class InformerBase(nn.Module):
    """Embeddings, decoder and projection; subclasses supply the encoder."""

    def __init__(self, config: InformerConfig):
        super().__init__()
        cfg = config
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype={cfg.dtype!r}: the port runs float32 activations only so "
                "far (ROADMAP Queue 1: bf16 activations)")
        self.config = cfg
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model)
        self.dec_embedding = DataEmbedding(cfg.dec_in, cfg.d_model)
        self.encoder = self._encoder(dict(
            n_heads=cfg.n_heads, d_ff=cfg.d_ff, activation=cfg.activation,
            attn=cfg.attn, distil=cfg.distil, output_attention=cfg.output_attention,
            use_pallas=cfg.use_pallas, pre_norm=cfg.pre_norm, fuse_qkv=cfg.fuse_qkv,
            lsq_nbits=cfg.lsq_nbits))
        self.decoder = Decoder(
            cfg.d_layers, cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
            activation=cfg.activation, attn=cfg.attn, mix=cfg.mix,
            use_pallas=cfg.use_pallas, pre_norm=cfg.pre_norm, fuse_qkv=cfg.fuse_qkv,
            lsq_nbits=cfg.lsq_nbits)
        self.projection = nn.Linear(cfg.d_model, cfg.c_out)

    def _encoder(self, kwargs) -> nn.Module:
        raise NotImplementedError

    def forward(self, x_enc, x_dec):
        if self.training:
            raise NotImplementedError(
                "the port serves only so far: call .eval() (ROADMAP Queue 1: "
                "training step)")
        cfg = self.config
        enc_out, attns = self.encoder(self.enc_embedding(x_enc))
        dec_out = self.decoder(self.dec_embedding(x_dec), enc_out)
        pred = self.projection(dec_out)[:, -cfg.pred_len:, :]
        return (pred, attns) if cfg.output_attention else pred


class Informer(InformerBase):
    """Single-resolution Informer (reference ``model.py:11-134``)."""

    def _encoder(self, kwargs):
        cfg = self.config
        e_layers = cfg.e_layers if isinstance(cfg.e_layers, int) else cfg.e_layers[0]
        return Encoder(e_layers, cfg.d_model, **kwargs)


class InformerStack(InformerBase):
    """Multi-resolution Informer stack (reference ``model.py:137-267``), the
    model of every reference experiment (e_layers (4, 3))."""

    def _encoder(self, kwargs):
        return EncoderStack(tuple(self.config.e_layers), self.config.d_model, **kwargs)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """Draw every weight from flax's default initialiser for that layer
    (dense and conv kernels lecun/kaiming truncated normal, biases zero,
    norms identity)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            dense_(m, generator)
        elif isinstance(m, (TokenEmbedding, ConvLayer)):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.reset_parameters()


def build_informer(config: InformerConfig, *, device=None, seed: int = 0) -> InformerBase:
    """An :class:`InformerStack` (or :class:`Informer` for one encoder) in
    ``eval()`` mode on ``device`` (default: the card; raises without one),
    with weights drawn from a ``torch.Generator`` seeded by ``seed``."""
    device = resolve_device(device)
    single = isinstance(config.e_layers, int) or len(config.e_layers) == 1
    model = (Informer if single else InformerStack)(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
