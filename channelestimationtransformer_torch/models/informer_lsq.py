"""LSQ-quantized Informer factory (JAX counterpart ``models/informer_lsq.py``;
reference ``models/InformerLSQ/`` and ``models/InformerLSQFibbinary/``).

Quantization is a config option threaded through the one model tree:
every attention projection and FFN layer becomes a ``DenseLSQ``
(``ops/quant/lsq.py``); the embeddings, distil convs and the output
projection stay FP32. Parameter names are those of the FP32 model plus a
``step_size`` per quantized layer.
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
