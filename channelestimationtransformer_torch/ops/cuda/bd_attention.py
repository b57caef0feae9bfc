"""Fused attention forward over ``[B, L, H, E]`` tensors: a hand-written
CUDA kernel (``csrc/bd_attention_fwd.cu``) and its plain torch version.

Replaces the TPU kernel ``ops/pallas/bd_attention.py:_fwd_kernel`` (launched
by ``_fwd_call``) of the JAX package, with dropout 0: per (batch, head),
``out = softmax(scale * Q K^T, masked) V``. The TPU kernel's block-diagonal
packing and 128-row key padding exist only to fill the TPU's matrix unit and
are not carried over; the source note in the ``.cu`` file gives the bound
on an H100 and what the design does about it.

:func:`bd_attention` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors. On a CUDA tensor it launches or raises: it never
falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

LIB_NAME = "bd_attention_fwd"
MAX_LK = 128  # key length limit (the TPU kernel's LP)
MAX_LQ = 512  # query length limit, as in the TPU kernel's _supported
MAX_E = 64  # head width limit of the CUDA kernel's shared-memory staging
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported_shape(q, k, v) -> bool:
    """Whether :func:`bd_attention` handles these ``[B, L, H, E]`` tensors."""
    _, l_q, _, e = q.shape
    l_k = k.shape[1]
    return (v.shape[-1] == e and 0 < l_k <= MAX_LK and 0 < l_q <= MAX_LQ
            and 0 < e <= MAX_E)


def bd_attention_reference(q, k, v, *, causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """The plain torch version: f32 math, output in the input dtype."""
    e = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    qf, kf, vf = (t.float() for t in (q, k, v))
    scores = torch.einsum("blhe,bshe->bhls", qf, kf) * scale
    if causal:
        l_q, l_k = q.shape[1], k.shape[1]
        mask = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, -math.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhls,bshd->blhd", p, vf).to(q.dtype)


def _lib():
    lib = _build.load(LIB_NAME)
    fn = lib.bd_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bd_attention(q, k, v, *, causal: bool = False,
                 scale: float | None = None) -> torch.Tensor:
    """Attention forward over ``[B, L, H, E]`` tensors (``E == D``).

    CPU tensors take :func:`bd_attention_reference`; CUDA tensors launch
    the kernel on the current stream without synchronising, and every
    launch adds one to ``bd_attention.launches``. Raises on a shape, dtype,
    layout or device the kernel does not take.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("bd_attention takes [B, L, H, E] tensors")
    b, l_q, h, e = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != e:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "k and v must be [B, L_k, H, E] with q's B, H and E")
    if not supported_shape(q, k, v):
        raise ValueError(f"bd_attention takes 0 < l_k <= {MAX_LK}, 0 < l_q <= {MAX_LQ} "
                         f"and E <= {MAX_E}; got l_q {l_q}, l_k {k.shape[1]}, E {e}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(e)
    if q.device.type == "cpu":
        return bd_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"bd_attention runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"bd_attention kernel takes float32 or bfloat16, not {q.dtype}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share one device and dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("bd_attention kernel takes contiguous [B, L, H, E] tensors")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, h, l_q, k.shape[1], e, scale, int(bool(causal)),
                     _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bd_attention_fwd launch failed: cudaError {err}")
    bd_attention.launches += 1
    return out


bd_attention.launches = 0
