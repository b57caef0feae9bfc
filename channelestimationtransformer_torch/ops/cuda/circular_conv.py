"""Circular convolution with three taps over ``[B, L, C]`` activations,
forward and gradients: hand-written CUDA kernels
(``csrc/circular_conv1d.cu``) and their plain torch versions.

Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
(``lax.conv_general_dilated``, ``models/embed.py:circular_conv1d``). With
``W`` ``[C_out, C_in, 3]``::

    forward  y[b,l,o]  = sum_t sum_i x[b,(l+t-1) mod L,i] W[o,i,t] + bias[o]
    dgrad    dx[b,l,i] = sum_t sum_o dy[b,(l-t+1) mod L,o] W[o,i,t]
    wgrad    dW[o,i,t] = sum_{b,l} dy[b,l,o] x[b,(l+t-1) mod L,i],  db[o] = sum_{b,l} dy[b,l,o]

all in float32 (FFMA; no TF32), on the tensors as they lie: the wrap is in
the kernels' index, so there is no pad copy and no transpose. The plain
versions are the same sums as one matmul over the three rolled copies
(``torch.roll``).

:func:`circular_conv1d` is the differentiable entry. CPU tensors take the
plain versions; CUDA float32 tensors launch the kernels or raise, never
falling back. A FLOP counter (``torch.utils.flop_counter``) sees aten ops
and not a ctypes launch, so counts are taken on the CPU
(``utils/complexity.py``). Each wrapper counts its launches:
``circular_conv1d_fwd.launches``, ``circular_conv1d_dgrad.launches``, and
``circular_conv1d_wgrad.launches`` (the partial sums) with
``circular_conv1d_wgrad.reductions`` (their reduction).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ...core.runtime import span
from . import _build

LIB = "circular_conv1d"
TAPS = 3
_SHIFT, _WGRAD = 0, 1  # circular_conv1d_smem kinds


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """``[..., L, C]`` -> ``[..., L, 3C]``: tap ``t``'s block holds row
    ``(l + t - 1) mod L``."""
    return torch.cat([torch.roll(x, 1 - t, dims=-2) for t in range(TAPS)], dim=-1)


def circular_conv1d_reference(x, weight, bias=None):
    """The plain forward: ``x`` ``[B, L, C_in]``, ``weight`` ``[C_out, C_in,
    3]``, ``bias`` ``[C_out]`` or None; one matmul over the rolled copies."""
    w = weight.permute(0, 2, 1).reshape(weight.shape[0], -1)  # [C_out, (t, i)]
    return torch.nn.functional.linear(_shifted(x), w, bias)


def circular_conv1d_dgrad_reference(dy, weight):
    """The plain data gradient ``dx`` ``[B, L, C_in]`` of ``dy`` ``[B, L,
    C_out]``: the forward with ``W`` transposed and its taps flipped."""
    return circular_conv1d_reference(dy, weight.transpose(0, 1).flip(-1))


def circular_conv1d_wgrad_reference(x, dy, with_bias: bool = True):
    """The plain weight gradient ``dW`` ``[C_out, C_in, 3]`` and, with
    ``with_bias``, ``db`` ``[C_out]`` (else None)."""
    c_out, c_in = dy.shape[-1], x.shape[-1]
    g = dy.reshape(-1, c_out).t() @ _shifted(x).reshape(-1, TAPS * c_in)  # [C_out, (t, i)]
    dw = g.reshape(c_out, TAPS, c_in).transpose(1, 2).contiguous()
    return dw, (dy.sum(dim=(0, 1)) if with_bias else None)


def _lib():
    lib = _build.load(LIB)
    if lib.circular_conv1d_shift.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.circular_conv1d_smem.argtypes = [i, i, ctypes.POINTER(i)]
        lib.circular_conv1d_shift.argtypes = [ptr] * 4 + [i] * 6 + [ptr]
        lib.circular_conv1d_wgrad_splits.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.circular_conv1d_wgrad.argtypes = [ptr] * 5 + [i] * 6 + [ptr]
        lib.circular_conv1d_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
        for fn in (lib.circular_conv1d_smem, lib.circular_conv1d_shift,
                   lib.circular_conv1d_wgrad_splits, lib.circular_conv1d_wgrad,
                   lib.circular_conv1d_occupancy):
            fn.restype = ctypes.c_int
    return lib


def _raise(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"circular_conv1d {what} launch failed: cudaError {err}")


@functools.cache
def _smem(kind: int, c_in: int) -> int:
    """The dynamic shared memory a launch of ``kind`` takes, in bytes, as
    the library reports it."""
    out = ctypes.c_int()
    _raise(_lib().circular_conv1d_smem(kind, c_in, ctypes.byref(out)), "shared memory query")
    return out.value


def _check(*tensors):
    """Raises on what the kernels do not take; returns the current stream."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"circular_conv1d runs on cpu or cuda tensors, not {x.device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"circular_conv1d kernels take float32, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("circular_conv1d's tensors must share one device")
        if not t.is_contiguous():
            raise ValueError("circular_conv1d kernels take contiguous tensors")
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_shapes(act, weight, channels: int):
    """``act`` ``[B, L, C]`` whose C is ``weight``'s dim ``channels``
    (1: C_in, 0: C_out) of ``[C_out, C_in, 3]``."""
    if act.dim() != 3 or weight.dim() != 3 or weight.shape[-1] != TAPS:
        raise ValueError(f"circular_conv1d takes [B, L, C] activations and [C_out, C_in, 3] "
                         f"weights, not {tuple(act.shape)} and {tuple(weight.shape)}")
    if act.shape[-1] != weight.shape[channels]:
        raise ValueError(f"activations {tuple(act.shape)}, weight {tuple(weight.shape)}: "
                         "channels disagree")


def circular_conv1d_fwd(x, weight, bias=None):
    """The forward kernel's wrapper: ``y`` ``[B, L, C_out]``. CPU tensors
    take :func:`circular_conv1d_reference`; CUDA tensors launch the kernel on
    the current stream without synchronising, one more in
    ``circular_conv1d_fwd.launches``."""
    if x.device.type == "cpu":
        return circular_conv1d_reference(x, weight, bias)
    stream = _check(x, weight, *(() if bias is None else (bias,)))
    _check_shapes(x, weight, 1)
    b, l, c_in = x.shape
    c_out = weight.shape[0]
    if bias is not None and bias.shape != (c_out,):
        raise ValueError(f"bias {tuple(bias.shape)} for {c_out} output channels")
    y = torch.empty(b, l, c_out, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        _raise(_lib().circular_conv1d_shift(x.data_ptr(), weight.data_ptr(),
                                            None if bias is None else bias.data_ptr(),
                                            y.data_ptr(), b, l, c_in, c_out, 0,
                                            _smem(_SHIFT, c_in), stream), "forward")
    circular_conv1d_fwd.launches += 1
    return y


circular_conv1d_fwd.launches = 0


def circular_conv1d_dgrad(dy, weight):
    """The data-gradient kernel's wrapper: ``dx`` ``[B, L, C_in]``. CPU
    tensors take :func:`circular_conv1d_dgrad_reference`; each CUDA launch
    adds one to ``circular_conv1d_dgrad.launches``."""
    if dy.device.type == "cpu":
        return circular_conv1d_dgrad_reference(dy, weight)
    stream = _check(dy, weight)
    _check_shapes(dy, weight, 0)
    b, l, c_out = dy.shape
    c_in = weight.shape[1]
    dx = torch.empty(b, l, c_in, device=dy.device, dtype=dy.dtype)
    with torch.cuda.device(dy.device):
        _raise(_lib().circular_conv1d_shift(dy.data_ptr(), weight.data_ptr(), None,
                                            dx.data_ptr(), b, l, c_in, c_out, 1,
                                            _smem(_SHIFT, c_in), stream), "data gradient")
    circular_conv1d_dgrad.launches += 1
    return dx


circular_conv1d_dgrad.launches = 0


@functools.cache
def _splits(device: int, b: int, l: int, c_in: int, c_out: int, smem: int) -> int:
    """Row splits of the weight gradient at these sizes on card ``device``
    (the library's choice, about one wave of resident blocks)."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        _raise(_lib().circular_conv1d_wgrad_splits(b, l, c_in, c_out, smem, ctypes.byref(out)),
               "split query")
    return out.value


def circular_conv1d_wgrad(x, dy, with_bias: bool = True):
    """The weight-gradient kernels' wrapper: ``(dW, db)``, ``dW`` ``[C_out,
    C_in, 3]`` and ``db`` ``[C_out]`` (None without ``with_bias``). CPU
    tensors take :func:`circular_conv1d_wgrad_reference`; on CUDA the rows
    are summed in splits into a scratch buffer, then the splits in a fixed
    order (no atomics: the same bits every run), adding one to
    ``circular_conv1d_wgrad.launches`` and one to ``.reductions``."""
    if x.device.type == "cpu":
        return circular_conv1d_wgrad_reference(x, dy, with_bias)
    stream = _check(x, dy)
    if x.dim() != 3 or dy.dim() != 3 or dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}: [B, L, C] with one B and L")
    b, l, c_in = x.shape
    c_out = dy.shape[-1]
    smem = _smem(_WGRAD, c_in)
    splits = _splits(x.device.index, b, l, c_in, c_out, smem)
    part = torch.empty(splits * c_out * (TAPS * c_in + 1), device=x.device, dtype=torch.float32)
    dw = torch.empty(c_out, c_in, TAPS, device=x.device, dtype=torch.float32)
    db = torch.empty(c_out, device=x.device, dtype=torch.float32) if with_bias else None
    with torch.cuda.device(x.device):
        _raise(_lib().circular_conv1d_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                            dw.data_ptr(), None if db is None else db.data_ptr(),
                                            b, l, c_in, c_out, splits, smem, stream),
               "weight gradient")
    circular_conv1d_wgrad.launches += 1
    circular_conv1d_wgrad.reductions += 1
    return dw, db


circular_conv1d_wgrad.launches = 0
circular_conv1d_wgrad.reductions = 0


class _CircularConv1d(torch.autograd.Function):
    """The forward kernel; the data- and weight-gradient kernels for the
    gradient, inside the ``cet.conv`` span (its kernels launch from
    autograd's thread). The data gradient runs only where the input needs
    one: not for an embedding, whose input is data."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return circular_conv1d_fwd(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        with span("cet.conv"):
            dy = dy.contiguous()
            if need_x:
                dx = circular_conv1d_dgrad(dy, weight)
            if need_w or need_b:
                dw, db = circular_conv1d_wgrad(x, dy, with_bias=need_b)
        return dx, (dw if need_w else None), db


def circular_conv1d(x, weight, bias=None):
    """Circular convolution of ``x`` ``[B, L, C_in]`` with ``weight``
    ``[C_out, C_in, 3]`` (and ``bias`` ``[C_out]``), differentiable; equal to
    torch's ``Conv1d(padding=1, padding_mode='circular')`` on the transposed
    input. CPU tensors take the plain versions, CUDA float32 tensors the
    kernels; the kernels raise on what they do not take."""
    if weight.shape[-1] != TAPS:
        raise ValueError(f"circular_conv1d takes three taps, not {weight.shape[-1]}")
    x, weight = x.contiguous(), weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return _CircularConv1d.apply(x, weight, bias)
    return circular_conv1d_fwd(x, weight, bias)
