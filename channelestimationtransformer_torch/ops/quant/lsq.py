"""LSQ (learned step size quantization) dense and conv layers and their
fibbinary variant (JAX counterpart ``ops/quant/lsq.py``; reference
``models/InformerLSQ/LSQ.py`` and ``models/InformerLSQFibbinary/LSQ.py``).

Semantics kept exactly, value for value:

- ``step_size`` initialised to ``mean(|w|)/sqrt(Qp)`` (reference ``LSQ.py:57``);
- gradient scale ``g = 1/sqrt(numel * Qp)`` (``LSQ.py:58``);
- the STE detach tricks ``grad_scale`` / ``round_pass`` (``LSQ.py:11-20``),
  whose values are the expressions as written, e.g. ``(x - x*g) + x*g``,
  which need not equal ``x`` in float32;
- quantized weight ``w_q = round(clamp(w/s, Qn, Qp)) * s`` (``LSQ.py:65-74``);
- the fibbinary variant snaps ``clamp(w/s, Qn, Qp)`` to the signed fibbinary
  codebook with ``bit_length <= nbits-1`` (``LSQFibbinary/LSQ.py:23-54``).
  On the card with ``use_pallas``, the whole chain of that case runs as one
  launch of the nearest-codeword kernel's LSQ mode (``_LsqCodeword``), whose
  values equal the eager chain's bit for bit and whose gradient is the eager
  chain's; on the CPU, or without ``use_pallas``, the eager chain runs.

Under tensor parallelism (``parallel/tensor.py``) a ``DenseLSQ`` holds its
rank's output rows and runs column-parallel: the rows are quantized where
they are, with ``g`` from the whole weight's ``numel`` (as JAX's global
array gives it), and the ``step_size`` gradient, a sum over every element
of the weight, is summed over the model group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...parallel.tensor import column_parallel, full_param, sum_grad_over
from ..cuda.quant import fused_lsq_codeword, nearest_codeword_reference
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


def _lsq_bounds(w, nbits: int, numel: int | None = None):
    """(Qn, Qp, g): the code range and the gradient scale ``1/sqrt(numel * Qp)``,
    ``numel`` the whole weight's (default ``w.numel()``; a shard passes its
    full weight's)."""
    qn = -(2 ** (nbits - 1))
    qp = 2 ** (nbits - 1) - 1
    return qn, qp, 1.0 / math.sqrt((w.numel() if numel is None else numel) * qp)


def _lsq_chain(w, step_size, nbits: int, codebook=None, *, use_pallas: bool = True,
               numel: int | None = None):
    """The eager chain (reference ``LSQ.py:65-74``): ~10 ops, each its own launch on the card."""
    qn, qp, g = _lsq_bounds(w, nbits, numel)
    s = grad_scale(step_size, g)
    scaled = torch.clamp(w / s, qn, qp)
    if codebook is None:
        return round_pass(scaled) * s
    return codebook_pass(scaled, codebook, use_pallas=use_pallas) * s


class _LsqCodeword(torch.autograd.Function):
    """The codebook case of :func:`lsq_quantize` in one kernel launch
    (``fused_lsq_codeword``). The backward rebuilds the eager chain on the
    saved weight and step size and differentiates it, so the gradients are
    the eager chain's; its snap takes the kernel, as the eager chain would
    (equal to the plain snap bit for bit)."""

    @staticmethod
    def forward(ctx, w, step_size, codebook, nbits, numel=None):
        ctx.save_for_backward(w, step_size, codebook)
        ctx.nbits, ctx.numel = nbits, numel
        qn, qp, g = _lsq_bounds(w, nbits, numel)
        return fused_lsq_codeword(w.detach(), step_size.detach(), codebook, g, qn, qp)

    @staticmethod
    def backward(ctx, grad):
        w, step_size, codebook = ctx.saved_tensors
        with torch.enable_grad():
            w_, s_ = w.detach().requires_grad_(), step_size.detach().requires_grad_()
            out = _lsq_chain(w_, s_, ctx.nbits, codebook, numel=ctx.numel)
        gw, gs = torch.autograd.grad(out, (w_, s_), grad)
        return (gw, gs) + (None,) * (len(ctx.needs_input_grad) - 2)


def lsq_quantize(w, step_size, nbits: int, codebook=None, *, use_pallas: bool = True,
                 numel: int | None = None):
    """The LSQ fake quantization of a weight tensor; with ``codebook``, the
    fibbinary snap in place of the rounding. The codebook case on a CUDA
    tensor with ``use_pallas`` is one kernel launch (through ``_LsqCodeword``
    when a gradient is needed, as ``bd_attention`` does). ``numel``: the
    whole weight's element count when ``w`` is a shard of it (``g``)."""
    if codebook is not None and use_pallas and w.device.type == "cuda":
        codebook = torch.as_tensor(codebook, dtype=torch.float32, device=w.device)
        if torch.is_grad_enabled() and (w.requires_grad or step_size.requires_grad):
            return _LsqCodeword.apply(w, step_size, codebook, nbits, numel)
        qn, qp, g = _lsq_bounds(w, nbits, numel)
        return fused_lsq_codeword(w, step_size, codebook, g, qn, qp)
    return _lsq_chain(w, step_size, nbits, codebook, use_pallas=use_pallas, numel=numel)


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
    weight's device once, with the module, and not on every forward.
    ``dtype`` is the compute dtype: the f32 weight is quantized in f32,
    then the quantized weight, the bias and x are cast to ``dtype`` for the
    product (JAX ``lsq.py:97-104``). With ``tp_group`` set
    (``parallel/tensor.py``) the weight holds this rank's output rows: they
    are quantized with ``g`` of the whole weight, the product runs
    column-parallel, and ``step_size``'s gradient is summed over the group."""

    tp_group = None

    def __init__(self, in_features: int, out_features: int, *, nbits: int,
                 fibbinary: bool = False, use_pallas: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.nbits = nbits
        self.use_pallas = use_pallas
        self.compute_dtype = dtype
        self.step_size = nn.Parameter(torch.empty(()))
        codebook = (torch.tensor(lsq_fibbinary_codebook(nbits), dtype=torch.float32)
                    if fibbinary else None)
        self.register_buffer("codebook", codebook, persistent=False)
        self.reset_step_size()

    @torch.no_grad()
    def reset_step_size(self) -> None:
        """``step_size`` from the current weight, as flax's lazy init does
        (JAX ``lsq.py:94-96``); a shard's from the whole weight, gathered (a
        collective over ``tp_group``)."""
        self.step_size.copy_(lsq_step_size_init(full_param(self, "weight"), self.nbits))

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp_group is None:
            w = lsq_quantize(self.weight, self.step_size, self.nbits, self.codebook,
                             use_pallas=self.use_pallas)
            return F.linear(x.to(dt), w.to(dt), self.bias.to(dt))
        w = lsq_quantize(self.weight, sum_grad_over(self.step_size, self.tp_group), self.nbits,
                         self.codebook, use_pallas=self.use_pallas,
                         numel=self.weight.numel() * dist.get_world_size(self.tp_group)).to(dt)
        return (column_parallel(lambda x: F.linear(x, w), x.to(dt), self.tp_group)
                + self.bias.to(dt))


class ConvLSQ(nn.Module):
    """1D conv with circular padding and optional LSQ weight quantization
    (reference ``Conv1dLSQ``, ``models/InformerLSQ/LSQ.py:77-314``; JAX
    ``ConvLSQ``, ``ops/quant/lsq.py:107-140``): ``kernel_size`` 1 (the
    reference's FFN convs, a dense product) or 3 (its distil conv).
    ``weight`` is torch's ``[C_out, C_in, K]``; ``quantize`` with ``nbits``
    adds ``step_size`` and fake-quantizes the weight on every forward as
    :class:`DenseLSQ` does (``fibbinary``: onto the codebook), else the
    layer is a plain conv. No model of the JAX package uses it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, *,
                 nbits: int | None = None, quantize: bool = False, fibbinary: bool = False,
                 use_pallas: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nbits = nbits if quantize else None
        self.use_pallas = use_pallas
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if self.nbits is not None:
            self.step_size = nn.Parameter(torch.empty(()))
        codebook = (torch.tensor(lsq_fibbinary_codebook(nbits), dtype=torch.float32)
                    if fibbinary and self.nbits is not None else None)
        self.register_buffer("codebook", codebook, persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's lecun-normal kernel (fan-in C_in * K), zero bias, and
        ``step_size`` from the weight."""
        from ...models.init import variance_scaling_

        variance_scaling_(self.weight, 1.0, generator=generator)
        nn.init.zeros_(self.bias)
        if self.nbits is not None:
            self.step_size.copy_(lsq_step_size_init(full_param(self, "weight"), self.nbits))

    def forward(self, x):
        from ...models.embed import circular_conv1d

        w = full_param(self, "weight")  # a shard's rows gathered (parallel/tensor.py)
        if self.nbits is not None:
            w = lsq_quantize(w, self.step_size, self.nbits, self.codebook,
                             use_pallas=self.use_pallas)
        dt = self.compute_dtype
        x, w, bias = x.to(dt), w.to(dt), self.bias.to(dt)
        if w.shape[-1] == 1:
            return F.linear(x, w[..., 0], bias)
        return circular_conv1d(x, w, bias)
