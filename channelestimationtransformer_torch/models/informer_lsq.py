"""LSQ-quantized Informer factory (JAX counterpart ``models/informer_lsq.py``;
reference ``models/InformerLSQ/`` and ``models/InformerLSQFibbinary/``).

Quantization is a config option threaded through the one model tree:
every attention projection and FFN layer becomes a ``DenseLSQ``
(``ops/quant/lsq.py``); the embeddings, distil convs and the output
projection stay FP32. Parameter names are those of the FP32 model plus a
``step_size`` per quantized layer, so an FP32 checkpoint overlays an LSQ
model name for name (``train/checkpoint.py:load_weights_overlay``, as
``cli/train_lsq.py`` preloads). The overlay leaves each ``step_size``
with the value it got from the LSQ model's own initial weights: that is
what the JAX package's code does (``Trainer.__post_init__`` initialises it
from the random kernel, ``train/trainer.py:344-348``, and the overlay of
``experiments/train_lsq.py:91-108`` leaves it alone), though that script's
docstring says it initialises from the loaded weights.
"""

from __future__ import annotations

import dataclasses

from ..core.config import InformerConfig
from .informer import InformerBase, build_informer


def build_informer_lsq(config: InformerConfig, *, nbits: int, fibbinary: bool = False,
                       device=None, seed: int = 0) -> InformerBase:
    """:func:`build_informer` of ``config`` with ``lsq_nbits=nbits`` and
    ``lsq_fibbinary=fibbinary``: in ``eval()`` mode on ``device`` (default:
    the card), weights from seed ``seed``, each ``step_size`` from its weight."""
    cfg = dataclasses.replace(config, lsq_nbits=nbits, lsq_fibbinary=fibbinary)
    return build_informer(cfg, device=device, seed=seed)
