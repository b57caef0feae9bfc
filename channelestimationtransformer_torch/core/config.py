"""Typed configuration for the model and the data.

The port keeps its own copy of the JAX package's frozen dataclasses
(``channelestimationtransformer_tpu/core/config.py``): same fields, same
defaults, same checks. Keyword-only fields make the reference's
positional-argument-shift bug impossible; the *effective* reference
hyperparameters (distil on, gelu activation) are the defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True, kw_only=True)
class InformerConfig:
    """Informer / InformerStack hyperparameters (the reference FullPrecision
    runs' effective config: distil on, gelu, full attention)."""

    enc_in: int = 16
    dec_in: int = 16
    c_out: int = 16
    seq_len: int = 90
    label_len: int = 10
    pred_len: int = 5
    factor: int = 5
    d_model: int = 128
    n_heads: int = 8
    e_layers: Sequence[int] = (4, 3)  # one entry per encoder in the stack
    d_layers: int = 3
    d_ff: int = 64
    dropout: float = 0.05
    attn: str = "full"  # "full" | "prob" | "ring" (only "full" is ported)
    activation: str = "gelu"  # "gelu" | "relu"
    distil: bool = True
    mix: bool = True  # transpose heads<->seq on decoder self-attn output
    output_attention: bool = False
    pre_norm: bool = False
    dtype: str = "float32"  # computation dtype for activations
    # Hand-written attention kernel (ops/cuda/bd_attention.py) for every
    # attention call; False = the plain torch path.
    use_pallas: bool = False
    fuse_qkv: bool = False
    lsq_nbits: int | None = None
    lsq_fibbinary: bool = False

    def __post_init__(self):
        if self.attn not in ("full", "prob", "ring"):
            raise ValueError(
                f"attn must be 'full', 'prob' or 'ring', got {self.attn!r}")
        if self.attn == "ring" and self.distil:
            raise ValueError(
                "attn='ring' shards the encoder sequence axis; the distilling "
                "conv pyramid produces shard-indivisible lengths — use "
                "distil=False for sequence-parallel configs")
        if self.activation not in ("gelu", "relu"):
            raise ValueError(f"activation must be 'gelu' or 'relu', got {self.activation!r}")

    @property
    def dec_len(self) -> int:
        return self.label_len + self.pred_len


@dataclasses.dataclass(frozen=True, kw_only=True)
class DataConfig:
    """Dataset geometry + noise model (reference ``Utils/dataset.py`` SeqData)."""

    seq_len: int = 90
    pred_len: int = 5
    snr_db: float = 21.0
    # Effective channel geometry after beamforming: Nr rx antennas x Nt beams,
    # flattened complex -> enc_in = nr * nt * 2 real features.
    nr: int = 2
    nt: int = 4
    slots: int = 100  # SRS slots per stored sample ("Seq_Len_100" datasets)

    @property
    def features(self) -> int:
        return self.nr * self.nt * 2
