"""LSQ (learned step size quantization) dense layer and its fibbinary
variant (JAX counterpart ``ops/quant/lsq.py``; reference
``models/InformerLSQ/LSQ.py`` and ``models/InformerLSQFibbinary/LSQ.py``).

Semantics kept exactly, value for value:

- ``step_size`` initialised to ``mean(|w|)/sqrt(Qp)`` (reference ``LSQ.py:57``);
- gradient scale ``g = 1/sqrt(numel * Qp)`` (``LSQ.py:58``);
- the STE detach tricks ``grad_scale`` / ``round_pass`` (``LSQ.py:11-20``),
  whose values are the expressions as written, e.g. ``(x - x*g) + x*g``,
  which need not equal ``x`` in float32;
- quantized weight ``w_q = round(clamp(w/s, Qn, Qp)) * s`` (``LSQ.py:65-74``);
- the fibbinary variant snaps ``clamp(w/s, Qn, Qp)`` to the signed fibbinary
  codebook with ``bit_length <= nbits-1`` (``LSQFibbinary/LSQ.py:23-54``),
  through the nearest-codeword CUDA kernel on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..cuda.quant import nearest_codeword_reference
from .codebooks import lsq_fibbinary_codebook, nearest_codeword


def grad_scale(x, scale):
    """Value ``(x - x*scale) + x*scale``, gradient scaled by ``scale``
    (reference ``LSQ.py:11-14``)."""
    return (x - x * scale).detach() + x * scale


def round_pass(x):
    """Value ``(round(x) - x) + x``, gradient identity (reference ``LSQ.py:17-20``)."""
    xd = x.detach()
    return (torch.round(xd) - xd) + x


def codebook_pass(x, codebook, *, use_pallas: bool = True):
    """Value ``(nearest codeword - x) + x``, gradient identity (reference
    ``LSQFibbinary/LSQ.py:23-45``). The snap runs on detached values, as
    JAX's ``stop_gradient`` has it, so the kernel needs no backward.
    ``use_pallas`` picks the kernel (its wrapper) or the plain version."""
    xd = x.detach()
    snap = nearest_codeword if use_pallas else nearest_codeword_reference
    return (snap(xd, codebook) - xd) + x


def lsq_quantize(w, step_size, nbits: int, codebook=None, *, use_pallas: bool = True):
    """The LSQ fake quantization of a weight tensor; with ``codebook``, the
    fibbinary snap in place of the rounding."""
    qn = -(2 ** (nbits - 1))
    qp = 2 ** (nbits - 1) - 1
    g = 1.0 / math.sqrt(w.numel() * qp)
    s = grad_scale(step_size, g)
    scaled = torch.clamp(w / s, qn, qp)
    if codebook is None:
        return round_pass(scaled) * s
    return codebook_pass(scaled, codebook, use_pallas=use_pallas) * s


def lsq_step_size_init(weight: torch.Tensor, nbits: int) -> torch.Tensor:
    """``mean(|w|)/sqrt(Qp)`` (reference ``LSQ.py:57``)."""
    qp = 2 ** (nbits - 1) - 1
    return weight.abs().mean() / math.sqrt(qp)


class DenseLSQ(nn.Linear):
    """``nn.Linear`` whose weight is LSQ fake-quantized on every forward
    (reference ``LinearLSQ``, ``models/InformerLSQ/LSQ.py:23-74``; JAX
    ``DenseLSQ`` with ``quantize=True``). ``weight`` is ``[out, in]``;
    ``step_size`` is a scalar parameter. ``fibbinary=True`` snaps to the
    signed fibbinary codebook, kept as a buffer so that it moves to the
    weight's device once, with the module, and not on every forward."""

    def __init__(self, in_features: int, out_features: int, *, nbits: int,
                 fibbinary: bool = False, use_pallas: bool = True):
        super().__init__(in_features, out_features)
        self.nbits = nbits
        self.use_pallas = use_pallas
        self.step_size = nn.Parameter(torch.empty(()))
        codebook = (torch.tensor(lsq_fibbinary_codebook(nbits), dtype=torch.float32)
                    if fibbinary else None)
        self.register_buffer("codebook", codebook, persistent=False)
        self.reset_step_size()

    @torch.no_grad()
    def reset_step_size(self) -> None:
        """``step_size`` from the current weight, as flax's lazy init does
        (JAX ``lsq.py:94-96``)."""
        self.step_size.copy_(lsq_step_size_init(self.weight, self.nbits))

    def forward(self, x):
        w = lsq_quantize(self.weight, self.step_size, self.nbits, self.codebook,
                         use_pallas=self.use_pallas)
        return F.linear(x, w, self.bias)
