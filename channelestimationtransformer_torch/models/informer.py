"""Informer and InformerStack, the flagship channel predictors (reference
``models/Informer/model.py``; JAX counterpart ``models/informer.py``).

Forward contract: ``model(enc_in [B, seq_len, F], dec_in [B, label_len +
pred_len, F]) -> pred [B, pred_len, c_out]`` (plus attention maps with
``output_attention``). In ``train()`` mode every dropout (embeddings,
attention probabilities, FFN, residuals) draws from the ``generator``
passed to ``forward``, and the distilling BatchNorms use and update batch
statistics; in ``eval()`` mode the forward is deterministic.

``config.dtype`` is flax's compute dtype: parameters (and so the optimizer
state) and BatchNorm statistics are f32 whatever it is; with "bfloat16"
every activation is bf16, the inputs are cast by the embeddings, and the
prediction comes out bf16, as the JAX package's does.

``attn="ring"`` shards the encoder's self-attention over the ``seq`` axis
of the ``mesh`` passed to the model (``parallel/ring.py``); the decoder's
self-attention is then full attention, as its cross-attention always is
(JAX ``models/decoder.py:41-42``). Such a model trains: the ring has a
backward, and every rank of the ``seq`` axis draws the same dropout masks
from the same generator, as the replicated model does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import InformerConfig, activation_dtype
from ..core.runtime import resolve_device
from ..ops.quant.lsq import DenseLSQ
from .attention import Dense
from .decoder import Decoder
from .embed import DataEmbedding, TokenEmbedding
from .encoder import ConvLayer, Encoder, EncoderStack
from .init import dense_


class InformerBase(nn.Module):
    """Embeddings, decoder and projection; subclasses supply the encoder."""

    def __init__(self, config: InformerConfig, *, mesh=None, seq_axis: str = "seq"):
        super().__init__()
        cfg = config
        dtype = activation_dtype(cfg.dtype)
        self.config = cfg
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model, cfg.dropout, dtype)
        self.dec_embedding = DataEmbedding(cfg.dec_in, cfg.d_model, cfg.dropout, dtype)
        self.encoder = self._encoder(dict(
            n_heads=cfg.n_heads, d_ff=cfg.d_ff, activation=cfg.activation,
            attn=cfg.attn, factor=cfg.factor, distil=cfg.distil,
            output_attention=cfg.output_attention,
            use_pallas=cfg.use_pallas, pre_norm=cfg.pre_norm, fuse_qkv=cfg.fuse_qkv,
            lsq_nbits=cfg.lsq_nbits, lsq_fibbinary=cfg.lsq_fibbinary, dropout=cfg.dropout,
            dtype=dtype, mesh=mesh, seq_axis=seq_axis))
        self.decoder = Decoder(
            cfg.d_layers, cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
            activation=cfg.activation, attn="full" if cfg.attn == "ring" else cfg.attn,
            factor=cfg.factor, mix=cfg.mix,
            use_pallas=cfg.use_pallas, pre_norm=cfg.pre_norm, fuse_qkv=cfg.fuse_qkv,
            lsq_nbits=cfg.lsq_nbits, lsq_fibbinary=cfg.lsq_fibbinary, dropout=cfg.dropout,
            dtype=dtype)
        self.projection = Dense(cfg.d_model, cfg.c_out, dtype=dtype)

    def _encoder(self, kwargs) -> nn.Module:
        raise NotImplementedError

    def forward(self, x_enc, x_dec, generator: torch.Generator | None = None):
        """``generator`` (on the inputs' device) feeds every dropout and
        every attention-kernel seed in train mode, where it is required when
        ``dropout`` > 0, and the ProbSparse layers' ``index_sample`` draws
        (``attn="prob"``) in train and in eval mode; a model with no prob
        layer draws nothing from it in eval mode. A prob model with no
        generator takes the fixed draws of a generator seeded 0."""
        cfg = self.config
        if self.training and cfg.dropout > 0.0 and generator is None:
            raise ValueError("train mode with dropout > 0 needs a torch.Generator "
                             "(model(x_enc, x_dec, generator=...))")
        enc_out, attns = self.encoder(self.enc_embedding(x_enc, generator), generator)
        dec_out = self.decoder(self.dec_embedding(x_dec, generator), enc_out, generator)
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
    norms identity). An LSQ layer draws its weight as a dense layer does,
    then sets ``step_size`` from it, as flax's lazy init does."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            dense_(m, generator)
            if isinstance(m, DenseLSQ):
                m.reset_step_size()
        elif isinstance(m, (TokenEmbedding, ConvLayer)):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.reset_parameters()


def build_informer(config: InformerConfig, *, device=None, seed: int = 0, mesh=None,
                   seq_axis: str = "seq") -> InformerBase:
    """An :class:`InformerStack` (or :class:`Informer` for one encoder) in
    ``eval()`` mode on ``device`` (default: the card; raises without one),
    with weights drawn from a ``torch.Generator`` seeded by ``seed``.
    ``mesh`` / ``seq_axis``: the device mesh of an ``attn="ring"`` model,
    whose encoder shards its sequence axis over that axis."""
    device = resolve_device(device)
    single = isinstance(config.e_layers, int) or len(config.e_layers) == 1
    model = (Informer if single else InformerStack)(config, mesh=mesh, seq_axis=seq_axis)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
