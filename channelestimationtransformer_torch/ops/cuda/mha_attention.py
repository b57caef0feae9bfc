"""Multi-head attention forward over ``[B, L, H, E]`` tensors: a hand-written
CUDA kernel (``csrc/mha_attention_fwd.cu``) and its plain torch version.

Replaces the TPU kernels ``ops/pallas/attention.py:_attn_kernel_blhe`` and
``_attn_kernel_small`` of the JAX package, both launched by its
``mha_attention``: per (batch, head), ``out = softmax(scale * Q K^T,
masked) V`` with q ``[B, Lq, H, E]``, k ``[B, Lk, H, E]``, v ``[B, Lk, H,
D]`` and out ``[B, Lq, H, D]``, any lengths, ``D != E`` allowed, and a
top-left causal mask (key j kept for query i iff ``j <= i``). The TPU
kernels' ``group`` is a grid setting of the TPU and is not carried over.

It is the model's eval route for the shapes that ``bd_attention`` does not
take (``models/attention.py``). Forward only, as the TPU kernels: it raises
where autograd would need its gradient.

The kernel has two routes, chosen by :func:`mha_route` and passed to its C
entry: "wgmma" (bf16 or float16, Lq > 32, E and D each 64 or 128, 16-byte
aligned tensors), a Hopper kernel of warpgroup MMAs fed by TMA from a producer warpgroup,
and "mma" (every other call), the ``mma.sync`` kernel.

CPU tensors take the plain version; CUDA tensors launch the kernel on their
route or raise, never falling back to the other route or the plain version.
Each launch adds one to ``mha_attention_fwd.launches`` and to its route's
count in ``mha_attention_fwd.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .bd_attention import bd_attention_reference

LIB = "mha_attention_fwd"
MAX_WIDTH = 128  # E and D limit of the kernel's shared-memory tiles
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("mma", "wgmma")  # the C entry's route codes, in order
WGMMA_WIDTHS = (64, 128)  # E and D of the wgmma route: one or two 128-byte TMA boxes
WGMMA_DTYPES = (torch.bfloat16, torch.float16)  # the wgmma route's 16-bit inputs


def mha_route(dtype, l_q: int, l_k: int, e: int, d: int, aligned: bool) -> str:
    """The kernel route of a call: "wgmma" for bf16 or float16 with
    ``l_q > 32`` (a consumer warpgroup takes 64 query rows), E and D each 64
    or 128, and q, k, v ``aligned`` to 16 bytes (TMA's rule); "mma" for
    every other call (f32, short queries, other widths). ``l_k`` takes any
    length on either route."""
    wgmma = (dtype in WGMMA_DTYPES and l_q > 32 and e in WGMMA_WIDTHS
             and d in WGMMA_WIDTHS and aligned)
    return "wgmma" if wgmma else "mma"


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def mha_attention_reference(q, k, v, *, causal: bool = False, scale: float | None = None):
    """The plain version: f32 math, output in q's dtype (JAX
    ``ops/pallas/attention.py:44-67``)."""
    return bd_attention_reference(q, k, v, causal=causal, scale=scale)


def _lib():
    fn = getattr(_build.load(LIB), LIB)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("mha_attention takes [B, L, H, E] tensors")
    b, l_q, h, e = q.shape
    l_k, d = k.shape[1], v.shape[3]
    if k.shape != (b, l_k, h, e) or v.shape[:3] != (b, l_k, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: k must "
                         "be [B, L_k, H, E] and v [B, L_k, H, D] with q's B, H and E")
    if l_q == 0 or l_k == 0:
        raise ValueError(f"mha_attention takes non-empty sequences; got l_q {l_q}, l_k {l_k}")
    if not (0 < e <= MAX_WIDTH and 0 < d <= MAX_WIDTH):
        raise ValueError(f"mha_attention takes E and D up to {MAX_WIDTH}; got E {e}, D {d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mha_attention takes float32, bfloat16 or float16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("mha_attention is forward only (as the TPU kernel it replaces): "
                           "call it under torch.no_grad() or on tensors without grad")


def mha_attention_fwd(q, k, v, *, causal: bool, scale: float):
    """The kernel's wrapper: ``out`` ``[B, Lq, H, D]`` in q's dtype. CPU
    tensors take :func:`mha_attention_reference`; CUDA tensors launch the
    kernel on :func:`mha_route`'s route, on the current stream without
    synchronising, and each launch adds one to
    ``mha_attention_fwd.launches`` and to its route's count in
    ``mha_attention_fwd.launches_by_route``."""
    if q.device.type == "cpu":
        return mha_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_attention runs on cpu or cuda tensors, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha_attention kernel takes contiguous [B, L, H, E] tensors")
    b, l_q, h, e = q.shape
    l_k, d = k.shape[1], v.shape[3]
    route = mha_route(q.dtype, l_q, l_k, e, d, aligned16(q, k, v))
    out = torch.empty(b, l_q, h, d, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, l_q, l_k,
                     e, d, scale, int(bool(causal)), _DTYPE_CODE[q.dtype], ROUTES.index(route),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mha_attention_fwd launch failed on the {route} route: "
                           f"cudaError {err}")
    mha_attention_fwd.launches += 1
    mha_attention_fwd.launches_by_route[route] += 1
    return out


mha_attention_fwd.launches = 0
mha_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def mha_attention(q, k, v, *, causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """Attention forward over ``[B, L, H, E]`` tensors (v ``[B, Lk, H, D]``),
    ``scale`` defaulting to ``1 / sqrt(E)``. Raises on a shape, dtype or
    device the kernel does not take, and when a gradient would be needed."""
    _check(q, k, v)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return mha_attention_fwd(q, k, v, causal=causal, scale=scale)
