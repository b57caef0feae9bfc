"""Functional fake-quantization ops (JAX counterpart
``ops/quant/functional.py``; reference: the vendored qtorch fork's
functional layer, ``FullPrecision/qtorch/quant/quant_function.py:269-448``).

:func:`fixed_point_quantize` is the weight transform of the
post-training-quantization sweep. It goes through the fused CUDA kernel of
``ops/cuda/quant.py`` on a CUDA tensor and through its plain version on a
CPU tensor; the plain version's helpers (``_fixed_bounds``,
``_round_to_grid``) live beside the kernel. Stochastic rounding draws one
seed from an explicit ``torch.Generator`` where JAX takes a ``key``, and
follows the kernel's 24-bit ``u`` where JAX's functional version draws
``jax.random.uniform``: parity with JAX is statistical there.
:class:`FixedPointWeightQuant` is the same transform as a value that
carries its format, so that ``apply_weight_quant`` can quantize every
tensor that shares it in one grouped launch (:meth:`~FixedPointWeightQuant.many`).

The codebook snaps :func:`fibonacci_quantize` and
:func:`no_adjacent_ones_quantize` go through the nearest-codeword kernel.

Progressive (incremental-QAT) quantization, :func:`fixed_point_quantize_partial`
and :func:`fibonacci_quantize_partial`, quantizes the fraction of a tensor's
weights closest to (``proximal``) or farthest from (``distant``) their
quantized value, or a random subset (``stochastic``). The quantized values
come from the kernels (nearest rounding, or the fibbinary snap); the
threshold is ``sort(|x - q|)[int32(float32(p) * (n - 1))]``, as the JAX
drivers compute it with a float32 ``p``, and ``<=`` (``>=``) takes every
tie. The stochastic subset is ``u < p`` with ``u`` the fixed-point kernel's
own uniform: the kernel rounds ``-p`` stochastically at ``fl = 0``, which
gives ``floor(u - p) = -1`` exactly where ``u < p``. :class:`FixedPointPartialWeightQuant`
and :class:`FibbinaryPartialWeightQuant` are the post-step transforms as
values: their ``many`` transforms a whole group with one kernel launch and
one ``torch.sort`` per numel class, bit for bit with the per-tensor path
(tensor ``t`` of a group draws its subset from Philox stream ``t``).

:func:`block_quantize` and :func:`float_quantize` (XLA work in JAX) are
torch ops. :func:`ste` and :func:`quantizer` are ``torch.autograd.Function``
wrappers: a ``torch.Generator`` takes the place of JAX's key, the forward
draws from it first and the backward afterwards.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..cuda.bd_attention import draw_seed
from ..cuda.quant import (
    _fixed_bounds,
    fused_fixed_point_quantize,
    fused_fixed_point_quantize_grouped,
)
from .codebooks import fibbinary_codebook, fibonacci_sequence_codebook, nearest_codeword
from .formats import BlockFloatingPoint, FixedPoint, FloatingPoint

PARTIAL_ROUNDINGS = ("proximal", "distant", "stochastic")


def fixed_point_quantize(x: torch.Tensor, wl: int, fl: int, *, clamp: bool = True,
                         symmetric: bool = False, rounding: str = "nearest",
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """Fixed-point fake quantization (reference ``quant_function.py:269-298``,
    kernels ``quant_cpu.cpp:117-164``). ``rounding="stochastic"`` draws its
    seed from ``generator`` (on x's device)."""
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    seed = None
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        seed = draw_seed(generator, x.device)
    return fused_fixed_point_quantize(x, wl, fl, clamp=clamp, symmetric=symmetric,
                                      stochastic=seed is not None, seed=seed)


@dataclasses.dataclass(frozen=True)
class FixedPointWeightQuant:
    """The weight transform ``fn(w, percentage, generator)`` of one
    fixed-point format: calling it is :func:`fixed_point_quantize` of one
    tensor (``percentage`` is not read, as in the sweep's closure, JAX
    ``experiments/ptq_sweep.py:99-103``). Equal quantizers are equal values,
    so ``apply_weight_quant`` gathers the tensors that share one and
    quantizes them with one :meth:`many` call."""

    wl: int
    fl: int
    rounding: str = "nearest"
    clamp: bool = True
    symmetric: bool = False

    def __post_init__(self):
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(f"unknown rounding {self.rounding!r}")

    def __call__(self, w: torch.Tensor, percentage: float = 1.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return fixed_point_quantize(w, self.wl, self.fl, clamp=self.clamp,
                                    symmetric=self.symmetric, rounding=self.rounding,
                                    generator=generator)

    def many(self, tensors, generator: torch.Generator | None = None) -> list:
        """Every tensor of ``tensors`` (one device) quantized in one grouped
        launch per ``MAX_GROUP`` tensors; stochastic rounding draws one
        seed from ``generator`` for the group, and tensor ``t`` its Philox
        stream ``t``."""
        tensors = list(tensors)
        seed = None
        if self.rounding == "stochastic" and tensors:
            if generator is None:
                raise ValueError("stochastic rounding needs a torch.Generator")
            seed = draw_seed(generator, tensors[0].device)
        return fused_fixed_point_quantize_grouped(
            tensors, self.wl, self.fl, clamp=self.clamp, symmetric=self.symmetric,
            stochastic=seed is not None, seed=seed)


def _snap(x, cb, clamp):
    q = nearest_codeword(x, cb)
    return q.clamp(float(cb.min()), float(cb.max())) if clamp else q


def fibonacci_quantize(x: torch.Tensor, wl: int, fl: int, *, clamp: bool = True) -> torch.Tensor:
    """Snap to the scaled-Fibonacci codebook (reference
    ``fibonacci_quantize_nearest``, ``quant_cpu.cpp:243-273``; positive
    codewords only, clamp to codebook range)."""
    return _snap(x, fibonacci_sequence_codebook(wl, fl), clamp)


def no_adjacent_ones_quantize(x: torch.Tensor, wl: int, fl: int, *,
                              clamp: bool = True) -> torch.Tensor:
    """Snap to the fibbinary (no-adjacent-ones) codebook (reference
    ``noAdjecentOnes_quantize_nearest``, ``quant_cpu.cpp:313-352``)."""
    return _snap(x, fibbinary_codebook(wl, fl), clamp)


def fixed_point_quantize_with_mask(x: torch.Tensor, wl: int, fl: int, *, symmetric: bool = False,
                                   rounding: str = "nearest",
                                   generator: torch.Generator | None = None):
    """Quantize and the boolean mask of the clamped elements (reference
    ``fixed_point_quantize_*_mask``, ``quant_cpu.cpp:80-115``): the kernel
    unclamped, then the mask ``(q > t_max) | (q < t_min)`` and the clamp."""
    q = fixed_point_quantize(x, wl, fl, clamp=False, symmetric=symmetric, rounding=rounding,
                             generator=generator)
    t_min, t_max = _fixed_bounds(wl, fl, symmetric)
    return q.clamp(t_min, t_max), (q > t_max) | (q < t_min)


def _threshold_index(percentage: float, n: int) -> int:
    """``int32(percentage * (n - 1))`` with ``percentage`` a float32, as the
    JAX drivers pass it (``jnp.float32(pct)``)."""
    return int(np.float32(percentage) * np.float32(n - 1))


def _partial_threshold(diffs: torch.Tensor, percentage: float, descending: bool) -> torch.Tensor:
    """The reference's threshold rule over each row of ``diffs`` ``[T, n]``:
    sort and take index ``int32(p * (n - 1))`` (``quant_cpu.cpp:185-191``;
    distant: the reverse sort). Returns ``[T, 1]``."""
    k = _threshold_index(percentage, diffs.shape[-1])
    return torch.sort(diffs, dim=-1, descending=descending).values[:, k:k + 1]


def _partial_seed(rounding, generator, device):
    if rounding not in PARTIAL_ROUNDINGS:
        raise ValueError(f"unknown partial rounding {rounding!r}")
    if rounding != "stochastic":
        return None
    if generator is None:
        raise ValueError("stochastic partial quantization needs a torch.Generator")
    return draw_seed(generator, device)


def _stochastic_draws(sizes, percentage: float, seed, device) -> list:
    """For tensor ``t`` of ``sizes`` (numels): -1 where ``u < p`` and 0
    elsewhere, ``u`` the fixed-point kernel's uniform on Philox stream ``t``
    of ``seed``. One grouped stochastic launch rounds ``-p`` at ``fl = 0``
    unclamped: ``floor(u - p)`` is -1 exactly where ``u < p`` (the sum is
    rounded once, which keeps its sign)."""
    minus_p = torch.full((max(sizes),), -float(np.float32(percentage)), device=device)
    return fused_fixed_point_quantize_grouped([minus_p[:n] for n in sizes], 32, 0, clamp=False,
                                              stochastic=True, seed=seed)


def _partial_rows(x, q, percentage: float, rounding: str, take=None):
    """``where(take, q, x)`` over rows ``[T, n]``: ``take`` by the rounding
    rule, all of a row at ``p >= 1``, none at ``p <= 0`` (JAX's edge
    selects, ``functional.py:146-148``; the same float32 ``p``)."""
    p = np.float32(percentage)
    if p >= 1.0:
        return q
    if p <= 0.0:
        return x
    if rounding == "stochastic":
        return torch.where(take, q, x)
    diffs = (x - q).abs()
    if rounding == "proximal":
        take = diffs <= _partial_threshold(diffs, percentage, descending=False)
    else:
        take = diffs >= _partial_threshold(diffs, percentage, descending=True)
    return torch.where(take, q, x)


def _partial_many(tensors, percentage, rounding, generator, snap, bounds) -> list:
    """The partial transform of every tensor of ``tensors`` (one device; one
    tensor is a group of one): one ``snap`` over their concatenation (one
    kernel launch), then per numel class one sort over the class's rows,
    the select and the clamp. Stochastic: one seed for the group, tensor
    ``t`` on stream ``t``."""
    tensors = list(tensors)
    if not tensors:
        return []
    device = tensors[0].device
    seed = _partial_seed(rounding, generator, device)
    classes = {}
    for i, t in enumerate(tensors):
        classes.setdefault(t.numel(), []).append(i)
    flat = torch.cat([tensors[i].reshape(-1) for idx in classes.values() for i in idx])
    q = snap(flat)
    draws = None
    if seed is not None and 0.0 < np.float32(percentage) < 1.0:
        draws = _stochastic_draws([t.numel() for t in tensors], percentage, seed, device)
    out = [None] * len(tensors)
    start = 0
    for n, idx in classes.items():
        rows = slice(start, start + n * len(idx))
        take = None if draws is None else torch.stack([draws[i] for i in idx]) < 0
        got = _partial_rows(flat[rows].view(len(idx), n), q[rows].view(len(idx), n), percentage,
                            rounding, take)
        if bounds is not None:
            got = got.clamp(*bounds)
        for r, i in enumerate(idx):
            out[i] = got[r].view(tensors[i].shape)
        start = rows.stop
    return out


def _nearest_snap(wl, fl, clamp, symmetric):
    return lambda x: fused_fixed_point_quantize(x, wl, fl, clamp=clamp, symmetric=symmetric)


def _fibbinary_snap(cb):
    return lambda x: nearest_codeword(x, cb)


def fixed_point_quantize_partial(x: torch.Tensor, percentage: float, wl: int, fl: int, *,
                                 clamp: bool = True, symmetric: bool = False,
                                 rounding: str = "proximal",
                                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Progressive (incremental-QAT) quantization: quantize only a fraction
    of the weights, chosen by distance to their quantized value (reference
    ``...QuantizationAwareTraining/qtorch/quant/quant_function.py:301-340``).
    ``proximal``: the ``percentage`` closest to their quantized value;
    ``distant``: the farthest; ``stochastic``: a random subset, drawn from
    ``generator``."""
    return FixedPointPartialWeightQuant(wl, fl, rounding, clamp, symmetric)(x, percentage,
                                                                            generator)


@functools.lru_cache(maxsize=None)
def _fibbinary_table(wl, fl, device):
    """The codebook on ``device`` and its bounds, made once: a copy to the
    card in every QAT step would wait for the step's queued work."""
    cb = fibbinary_codebook(wl, fl)
    return (torch.as_tensor(cb, dtype=torch.float32, device=device),
            (float(cb.min()), float(cb.max())))


def fibonacci_quantize_partial(x: torch.Tensor, wl: int, fl: int, percentage: float, *,
                               clamp: bool = True, rounding: str = "proximal",
                               generator: torch.Generator | None = None) -> torch.Tensor:
    """Progressive quantization onto **fibbinary** codewords (reference
    ``...QATFibonacci/qtorch/quant/quant_function.py:298-336`` +
    ``quant.cu:249-430``; despite the name, the codebook is fibbinary)."""
    return FibbinaryPartialWeightQuant(wl, fl, rounding, clamp)(x, percentage, generator)


@dataclasses.dataclass(frozen=True)
class FixedPointPartialWeightQuant:
    """The QAT post-step transform ``fn(w, percentage, generator)`` of one
    fixed-point format (:func:`fixed_point_quantize_partial` of one tensor,
    a group of one); :meth:`many` transforms a group (``apply_weight_quant``
    gathers the tensors that share one)."""

    wl: int
    fl: int
    rounding: str = "proximal"
    clamp: bool = True
    symmetric: bool = False

    def __post_init__(self):
        if self.rounding not in PARTIAL_ROUNDINGS:
            raise ValueError(f"unknown partial rounding {self.rounding!r}")

    def __call__(self, w: torch.Tensor, percentage: float = 1.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return self.many([w], percentage, generator)[0]

    def many(self, tensors, percentage: float = 1.0,
             generator: torch.Generator | None = None) -> list:
        """Every tensor of ``tensors``: one fixed-point launch over all of
        them, one sort per numel class; tensor by tensor what
        :meth:`__call__` gives (stochastic: on its Philox stream of the
        group's seed)."""
        bounds = _fixed_bounds(self.wl, self.fl, self.symmetric) if self.clamp else None
        return _partial_many(tensors, percentage, self.rounding, generator,
                             _nearest_snap(self.wl, self.fl, self.clamp, self.symmetric), bounds)


@dataclasses.dataclass(frozen=True)
class FibbinaryPartialWeightQuant:
    """The QAT post-step transform onto the fibbinary codebook
    (:func:`fibonacci_quantize_partial` of one tensor, a group of one);
    :meth:`many` snaps a whole group in one codeword launch, as its
    tensors share one codebook."""

    wl: int
    fl: int
    rounding: str = "proximal"
    clamp: bool = True

    def __post_init__(self):
        if self.rounding not in PARTIAL_ROUNDINGS:
            raise ValueError(f"unknown partial rounding {self.rounding!r}")

    def __call__(self, w: torch.Tensor, percentage: float = 1.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return self.many([w], percentage, generator)[0]

    def many(self, tensors, percentage: float = 1.0,
             generator: torch.Generator | None = None) -> list:
        tensors = list(tensors)
        if not tensors:
            return []
        cb, bounds = _fibbinary_table(self.wl, self.fl, torch.device(tensors[0].device))
        return _partial_many(tensors, percentage, self.rounding, generator, _fibbinary_snap(cb),
                             bounds if self.clamp else None)


def block_quantize(x: torch.Tensor, wl: int, *, dim: int = -1, rounding: str = "nearest",
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Block floating point: a shared exponent from the block's max |x|, a
    ``wl``-bit signed mantissa (reference ``block_quantize_nearest``,
    ``quant_cpu.cpp:410-455``: offset ``wl - 2``). ``dim=-1`` shares one
    exponent over the whole tensor, else one per slice along ``dim``.

    The exponent is ``floor(log2(max|x|))`` with ``torch.log2``, as JAX's
    ``jnp.log2``, not ``frexp``: float32 ``log2`` of a value just below a
    power of two can round up to that power's integer, and both packages
    then take the exponent one higher."""
    if dim == -1:
        max_entry = x.abs().max()
    else:
        axes = tuple(i for i in range(x.dim()) if i != dim % x.dim())
        max_entry = x.abs().amax(dim=axes, keepdim=True)
    exponent = torch.floor(torch.log2(torch.clamp(max_entry, min=1e-38)))
    i = x * torch.pow(2.0, -exponent + (wl - 2))
    if rounding == "nearest":
        i = torch.round(i)
    elif rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        i = torch.floor(i + torch.rand(x.shape, generator=generator, device=x.device,
                                       dtype=x.dtype))
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    lim = 2.0 ** (wl - 1) - 1.0
    return i.clamp(-lim, lim) * torch.pow(2.0, exponent - (wl - 2))


def float_quantize(x: torch.Tensor, exp: int, man: int, *, rounding: str = "nearest",
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Low-bit float with ``exp`` exponent and ``man`` mantissa bits and
    subnormals (reference ``float_quantize_nearest``,
    ``quant_cpu.cpp:493-536``), on the int32 bits of float32 as JAX's
    ``bitcast_convert_type``. Nearest rounding adds half an ulp in bit
    space (half away from zero); the subnormal grid rounds with
    ``torch.round`` (half to even, as ``jnp.round``)."""
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "stochastic" and generator is None:
        raise ValueError("stochastic rounding needs a torch.Generator")
    x32 = x.to(torch.float32)
    bits = x32.view(torch.int32)
    sign = bits & -(2**31)
    mag = bits ^ sign  # |x| bits
    max_exp_unbiased = 2 ** (exp - 1) - 1
    min_exp_unbiased = -(2 ** (exp - 1)) + 2  # smallest normal
    subnormal = ((mag >> 23) - 127) < min_exp_unbiased
    shift = 23 - man
    if shift > 0:
        if rounding == "nearest":
            add = 1 << (shift - 1)
        else:
            add = torch.randint(0, 1 << shift, x.shape, generator=generator, device=x.device,
                                dtype=torch.int32)
        q_mag = ((mag + add) >> shift) << shift
    else:
        q_mag = mag
    max_val_bits = ((max_exp_unbiased + 127) << 23) | (((1 << man) - 1) << shift)
    normal = (torch.clamp(q_mag, max=max_val_bits) | sign).view(torch.float32)
    # A tensor divisor: CUDA turns a division by a host scalar into a product
    # by its reciprocal, which overflows for the smallest grids (2^-149).
    sub_scale = 2.0 ** (min_exp_unbiased - man)
    scaled = x32 / x32.new_tensor(sub_scale)
    if rounding == "nearest":
        sub = torch.round(scaled) * sub_scale
    else:
        sub = torch.floor(scaled + torch.rand(x.shape, generator=generator, device=x.device)
                          ) * sub_scale
    return torch.where(subnormal, sub, normal).to(x.dtype)


class _Ste(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, quant_fn):
        return quant_fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste(x: torch.Tensor, quant_fn) -> torch.Tensor:
    """``quant_fn(x)`` in the forward pass, the identity gradient in the
    backward pass: the straight-through estimator of every qtorch fake-quant
    op (reference ``quant_function.py:61-266``)."""
    return _Ste.apply(x, quant_fn)


def _apply_format(v, number, rounding, generator):
    if number is None:
        return v
    if isinstance(number, FixedPoint):
        return fixed_point_quantize(v, number.wl, number.fl, clamp=number.clamp,
                                    symmetric=number.symmetric, rounding=rounding,
                                    generator=generator)
    if isinstance(number, BlockFloatingPoint):
        return block_quantize(v, number.wl, dim=number.dim, rounding=rounding, generator=generator)
    if isinstance(number, FloatingPoint):
        return float_quantize(v, number.exp, number.man, rounding=rounding, generator=generator)
    raise TypeError(f"unsupported number format {number!r}")


class _Quantize(torch.autograd.Function):
    """Forward per ``spec.forward_number``; backward zeroes the gradient where
    the forward clamped (``clamping_grad_zero``) and quantizes it per
    ``spec.backward_number``."""

    @staticmethod
    def forward(ctx, x, spec, generator):
        ctx.spec, ctx.generator = spec, generator
        number = spec.forward_number
        if spec.clamping_grad_zero and isinstance(number, FixedPoint):
            out, mask = fixed_point_quantize_with_mask(
                x, number.wl, number.fl, symmetric=number.symmetric,
                rounding=spec.forward_rounding, generator=generator)
            ctx.save_for_backward(mask)
            return out
        return _apply_format(x, number, spec.forward_rounding, generator)

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        if ctx.saved_tensors:
            g = torch.where(ctx.saved_tensors[0], 0.0, g)
        return _apply_format(g, spec.backward_number, spec.backward_rounding, ctx.generator), \
            None, None


@dataclasses.dataclass(frozen=True)
class _QuantizerSpec:
    forward_number: object
    backward_number: object
    forward_rounding: str
    backward_rounding: str
    clamping_grad_zero: bool


def quantizer(*, forward_number=None, backward_number=None, forward_rounding: str = "nearest",
              backward_rounding: str = "nearest", clamping_grad_zero: bool = False):
    """A differentiable fake-quantizer, as qtorch ``quantizer()`` (reference
    ``quant_function.py:61-266``): activations quantized in the forward pass
    per ``forward_number``, gradients in the backward pass per
    ``backward_number``; with ``clamping_grad_zero`` (fixed point only) the
    gradient is zeroed where the forward pass clamped.

    Returns ``fn(x, generator=None)``. Stochastic rounding draws from
    ``generator`` (on x's device; JAX's default ``key(0)`` becomes a
    generator seeded 0): the forward's draws when it runs, the backward's
    when it runs. Where no gradient is taken, ``fn`` is the forward format
    alone (JAX's primal)."""
    spec = _QuantizerSpec(forward_number, backward_number, forward_rounding, backward_rounding,
                          clamping_grad_zero)

    def fn(x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Quantize.apply(x, spec, generator)
        return _apply_format(x, forward_number, forward_rounding, generator)

    return fn
