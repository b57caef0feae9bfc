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

import numpy as np
import torch

# Activation dtypes the port runs (``InformerConfig.dtype``). Parameters and
# optimizer state stay float32 whatever the dtype, as flax keeps them.
ACTIVATION_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def activation_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of an ``InformerConfig.dtype`` string. A float
    dtype the port does not run (float16, float64: the JAX package's
    ``jnp.dtype`` takes them) raises ``NotImplementedError``; a string that
    names no float dtype raises ``ValueError``."""
    if name in ACTIVATION_DTYPES:
        return ACTIVATION_DTYPES[name]
    try:
        floating = np.issubdtype(np.dtype(name), np.floating)
    except TypeError:
        floating = False
    if floating:
        raise NotImplementedError(
            f"dtype={name!r}: the port runs float32 and bfloat16 activations only "
            "(ROADMAP Queue 1, standing limits: float16 and the other float dtypes are not "
            "ported)")
    raise ValueError(f"dtype must name a float dtype ('float32' or 'bfloat16'), got {name!r}")


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
    attn: str = "full"  # "full" | "prob" | "ring" (the encoder's self-attention, parallel/ring.py)
    activation: str = "gelu"  # "gelu" | "relu"
    distil: bool = True
    mix: bool = True  # transpose heads<->seq on decoder self-attn output
    output_attention: bool = False
    pre_norm: bool = False
    dtype: str = "float32"  # activations: "float32" | "bfloat16" (activation_dtype)
    # Hand-written kernels: attention (ops/cuda/bd_attention.py where it takes
    # the shape, else ops/cuda/mha_attention.py in eval mode; routing in
    # models/attention.py) and, with lsq_fibbinary, the nearest-codeword snap
    # (ops/cuda/quant.py); False = the plain torch path.
    use_pallas: bool = False
    # One qkv projection to 3 * d_model in self-attention, a query and one kv
    # projection in cross-attention (JAX models/attention.py:252-262); off
    # under LSQ.
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
class TransformerConfig:
    """Vanilla encoder-decoder transformer baseline (reference
    ``models/Transformer/model.py:90-174`` ``build_transformer``; JAX
    ``core/config.py:86-105``). ``dtype`` goes through :func:`activation_dtype`
    when the model is built."""

    enc_in: int = 16
    c_out: int = 16
    seq_len: int = 90
    label_len: int = 10
    pred_len: int = 5
    d_model: int = 128
    n_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 3
    d_ff: int = 64
    dropout: float = 0.05
    dtype: str = "float32"

    @property
    def dec_len(self) -> int:
        return self.label_len + self.pred_len


RECURRENT_CELLS = ("rnn", "gru", "lstm")


@dataclasses.dataclass(frozen=True, kw_only=True)
class RecurrentConfig:
    """RNN/GRU/LSTM baselines (reference ``models/{RNN,GRU,LSTM}/model.py``;
    JAX ``core/config.py:108-120``): Linear encoder -> recurrent core ->
    Linear decoder, teacher-forced train, closed-loop eval rollout."""

    features: int = 16
    input_size: int = 128
    hidden_size: int = 256
    num_layers: int = 2
    cell: str = "lstm"  # "rnn" | "gru" | "lstm"
    dtype: str = "float32"

    def __post_init__(self):
        if self.cell not in RECURRENT_CELLS:
            raise ValueError(f"cell must be 'rnn', 'gru' or 'lstm', got {self.cell!r}")


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


@dataclasses.dataclass(frozen=True, kw_only=True)
class TrainConfig:
    """Optimizer / loop settings (reference ``FullPrecision/config.py``:
    batch 256, Adam lr 1e-4, cosine annealing, 1000-epoch ceiling)."""

    batch_size: int = 256
    num_epochs: int = 100
    lr: float = 1e-4
    lr_min: float = 0.0
    weight_decay: float = 0.0  # >0 switches Adam -> AdamW (decoupled decay)
    seed: int = 0
    steps_per_epoch: int = 226  # reference: 226 batches/epoch at batch 256
    warmup_steps: int = 1000  # linear LR warmup (0 = reference plain cosine)
    # "warmup_cosine" (default) or "constant". The reference's committed
    # SNR-sweep logs train with a CONSTANT lr 1e-3 for all 50 epochs
    # (FullPrecision/Figures/SNR.txt: every `| lr` field is 1.000000e-03),
    # despite config.py nominally specifying cosine annealing — use
    # "constant" when replicating those runs.
    schedule: str = "warmup_cosine"
    checkpoint_every_epochs: int = 100
    log_every: int = 22  # ~len/10 per the reference logging cadence
    # Kept for field parity with the JAX config, where it picks the JAX PRNG
    # key implementation. torch has no counterpart: the port's streams are
    # torch.Generators (Philox on the card), and this field is not read.
    prng_impl: str = "threefry2x32"
    checkpoint_dir: str = "weights"
    experiment_name: str = "runs/tmodel"


def full_precision_config() -> tuple[InformerConfig, DataConfig, TrainConfig]:
    """The FullPrecision experiment's effective configuration
    (reference ``FullPrecision/config.py:4-33`` + SURVEY §7.4 quirk 1)."""
    return InformerConfig(), DataConfig(), TrainConfig()
