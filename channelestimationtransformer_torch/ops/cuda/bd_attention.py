"""Fused attention over ``[B, L, H, E]`` tensors, forward and backward: two
hand-written CUDA kernels (``csrc/bd_attention_fwd.cu``,
``csrc/bd_attention_bwd.cu``) and their plain torch versions.

Replaces the TPU kernels ``ops/pallas/bd_attention.py:_fwd_kernel`` and
``_bwd_kernel`` of the JAX package (launched by ``_fwd_call`` and
``_bwd_call`` and tied together by the ``custom_vjp`` ``_bd_attention``):
per (batch, head), ``out = dropout(softmax(scale * Q K^T, masked)) V`` and
its gradient. The TPU kernels' block-diagonal packing and 128-row key
padding exist only to fill the TPU's matrix unit and are not carried over;
the source notes in the ``.cu`` files give the bounds on an H100 and what
each design does about them.

Attention-probability dropout. The TPU kernels draw the keep mask from the
TPU's hardware PRNG (``_dropout_mask``). Here it is a stateless
Philox4x32-10 keyed by a seed that lives on the device, so neither the
forward nor the backward stores the mask or reads the seed on the host:

    key     = (seed & 0xffffffff, seed >> 32)   seed: 1-element int64 tensor
    counter = (col // 4, row, b * H + h, 0)     (row: query, col: key position)
    word    = output word ``col % 4`` of Philox4x32-10(counter, key)
    keep    = word < min(int(keep_prob * 2**32), 2**32 - 1)

and kept probabilities are scaled by ``1 / keep_prob``. The two kernels and
:func:`dropout_keep_mask` compute the same bits, so kernel and plain version
agree exactly at any rate. The JAX package's bits are another generator's:
parity with it is exact at dropout 0 and statistical above.

:func:`bd_attention` is the entry point. CPU tensors take the plain
versions; CUDA tensors launch the kernels or raise, never falling back.
Each kernel wrapper counts its launches (``bd_attention_fwd.launches``,
``bd_attention_bwd.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

FWD_LIB = "bd_attention_fwd"
BWD_LIB = "bd_attention_bwd"
MAX_LK = 128  # key length limit (the TPU kernel's LP)
MAX_LQ = 512  # query length limit, as in the TPU kernel's _supported
MAX_E = 64  # head width limit of the CUDA kernels' shared-memory staging
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    an int64 tensor ``b`` in [0, 2**32). The 64-bit product would overflow
    int64, so ``a`` is split into 16-bit halves and no partial product
    exceeds 2**49."""
    mid = b * (a >> 16)
    t = b * (a & 0xFFFF) + ((mid & 0xFFFF) << 16)
    return (mid >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Random123) on int64 tensors holding 32-bit words:
    counter ``(c0, c1, c2, c3)``, key ``(k0, k1)``; returns the four output
    words. Tensors broadcast against each other."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(keep_prob: float) -> int:
    """A 32-bit word keeps its element iff it is below this (JAX
    ``ops/pallas/bd_attention.py:117``)."""
    return min(int(keep_prob * float(1 << 32)), (1 << 32) - 1)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """A dropout seed for one attention call: a 1-element int64 tensor drawn
    on ``device`` from ``generator``. It stays on the device (the kernels
    read it through a pointer), so drawing it does not synchronise."""
    return torch.randint(0, 2**63 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def dropout_keep_mask(seed: torch.Tensor, b: int, h: int, l_q: int, l_k: int,
                      keep_prob: float) -> torch.Tensor:
    """The kernels' keep mask, ``[B, H, l_q, l_k]`` bool, on ``seed``'s
    device (the layout is in the module docstring)."""
    s = seed.reshape(()).to(torch.int64)
    dev = s.device
    groups = (l_k + 3) // 4
    c0, c1, c2 = torch.broadcast_tensors(
        torch.arange(groups, device=dev).view(1, 1, groups),
        torch.arange(l_q, device=dev).view(1, l_q, 1),
        torch.arange(b * h, device=dev).view(b * h, 1, 1))
    words = philox4x32_10(c0, c1, c2, torch.zeros_like(c0), s & _MASK32,
                          (s >> 32) & _MASK32)
    words = torch.stack(words, dim=-1).reshape(b, h, l_q, 4 * groups)[..., :l_k]
    return words < keep_threshold(keep_prob)


def supported_shape(q, k, v) -> bool:
    """Whether :func:`bd_attention` handles these ``[B, L, H, E]`` tensors."""
    _, l_q, _, e = q.shape
    l_k = k.shape[1]
    return (v.shape[-1] == e and 0 < l_k <= MAX_LK and 0 < l_q <= MAX_LQ
            and 0 < e <= MAX_E)


def _scores(q, k, causal, scale):
    s = torch.einsum("blhe,bshe->bhls", q, k) * scale
    if causal:
        l_q, l_k = q.shape[1], k.shape[1]
        mask = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, -math.inf)
    return s


def _reference_forward(q, k, v, *, causal, scale, dropout, seed, with_lse):
    """Plain forward: the output in the input dtype and, ``with_lse``, the
    row log-sum-exp ``[B, H, l_q]`` (f32) that the backward reads."""
    s = _scores(q.float(), k.float(), causal, scale)
    p = torch.softmax(s, dim=-1)
    if dropout > 0.0:
        b, l_q, h, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, l_q, k.shape[1], 1.0 - dropout)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout)), 0.0)
    out = torch.einsum("bhls,bshd->blhd", p, v.float()).to(q.dtype)
    return out, (torch.logsumexp(s, dim=-1) if with_lse else None)


def bd_attention_reference(q, k, v, *, causal: bool = False, scale: float | None = None,
                           dropout: float = 0.0, seed: torch.Tensor | None = None):
    """The plain forward: f32 math, output in the input dtype. With
    ``dropout`` > 0, P is masked by :func:`dropout_keep_mask` and scaled by
    ``1 / (1 - dropout)`` before P·V (JAX ``bd_attention.py:139-144``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                              seed=seed, with_lse=False)[0]


def bd_attention_bwd_reference(q, k, v, o, do, lse, seed=None, *, causal: bool = False,
                               scale: float | None = None, dropout: float = 0.0):
    """The plain backward, the formulas of JAX ``_bwd_kernel``
    (``bd_attention.py:166-209``) without its packing: P recomputed from
    ``lse``; dP' = keep·(1/keep_prob)·(dO·Vᵀ); dS = P∘(dP' − D)·scale with
    D = rowsum(dO∘O) (equal to JAX's ``sum(dp * p)``); dQ = dS·K,
    dK = dSᵀ·Q, dV = P_dropᵀ·dO. f32 math, results in the input dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(_scores(qf, kf, causal, scale) - lse[..., None])
    dp = torch.einsum("blhd,bshd->bhls", dof, vf)
    p_drop = p
    if dropout > 0.0:
        b, l_q, h, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, l_q, k.shape[1], 1.0 - dropout)
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
    d = (dof * of).sum(-1).transpose(1, 2)[..., None]  # [B, H, l_q, 1]
    ds = p * (dp - d) * scale
    dq = torch.einsum("bhls,bshe->blhe", ds, kf)
    dk = torch.einsum("bhls,blhe->bshe", ds, qf)
    dv = torch.einsum("bhls,blhd->bshd", p_drop, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib(name):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        n_ptr = 6 if name == FWD_LIB else 10
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("bd_attention takes [B, L, H, E] tensors")
    b, l_q, h, e = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != e:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "k and v must be [B, L_k, H, E] with q's B, H and E")
    if not supported_shape(q, k, v):
        raise ValueError(f"bd_attention takes 0 < l_k <= {MAX_LK}, 0 < l_q <= {MAX_LQ} "
                         f"and E <= {MAX_E}; got l_q {l_q}, l_k {k.shape[1]}, E {e}")


def _check_cuda(tensors, seed):
    """Raises on what the kernels do not take; returns the device's stream."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"bd_attention runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"bd_attention kernel takes float32, bfloat16 or float16, not {q.dtype}")
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v (and o, do) must share one device and dtype")
        if not t.is_contiguous():
            raise ValueError("bd_attention kernel takes contiguous [B, L, H, E] tensors")
    if seed is not None and (seed.device != q.device or seed.dtype != torch.int64
                             or seed.numel() != 1):
        raise ValueError("the dropout seed must be a 1-element int64 tensor on q's device")
    return torch.cuda.current_stream(q.device).cuda_stream


def _dropout_args(dropout, seed):
    if dropout <= 0.0:
        return None, 0, 1.0
    return seed, keep_threshold(1.0 - dropout), 1.0 / (1.0 - dropout)


def _ptr(t):
    return None if t is None else t.data_ptr()


def bd_attention_fwd(q, k, v, seed=None, *, causal: bool, scale: float, dropout: float,
                     with_lse: bool):
    """The forward kernel's wrapper: ``(out, lse)``, ``lse`` ``[B, H, l_q]``
    f32 when ``with_lse`` else None. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream without
    synchronising, and each launch adds one to ``bd_attention_fwd.launches``."""
    if q.device.type == "cpu":
        return _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                                  seed=seed, with_lse=with_lse)
    seed, thresh, inv_keep = _dropout_args(dropout, seed)
    stream = _check_cuda((q, k, v), seed)
    b, l_q, h, e = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l_q, device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):
        err = _lib(FWD_LIB)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            _ptr(lse), _ptr(seed), b, h, l_q, k.shape[1], e, scale,
                            int(bool(causal)), thresh, inv_keep, _DTYPE_CODE[q.dtype],
                            stream)
    if err != 0:
        raise RuntimeError(f"bd_attention_fwd launch failed: cudaError {err}")
    bd_attention_fwd.launches += 1
    return out, lse


bd_attention_fwd.launches = 0


def bd_attention_bwd(q, k, v, o, do, lse, seed=None, *, causal: bool, scale: float,
                     dropout: float):
    """The backward kernel's wrapper: ``(dq, dk, dv)`` in the input dtype.
    CPU tensors take :func:`bd_attention_bwd_reference`; CUDA tensors launch
    the kernel (deterministic: no atomics), and each launch adds one to
    ``bd_attention_bwd.launches``."""
    if q.device.type == "cpu":
        return bd_attention_bwd_reference(q, k, v, o, do, lse, seed, causal=causal,
                                          scale=scale, dropout=dropout)
    seed, thresh, inv_keep = _dropout_args(dropout, seed)
    stream = _check_cuda((q, k, v, o, do), seed)
    if (lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1])):
        raise ValueError("lse must be a contiguous float32 [B, H, l_q] tensor on q's device")
    b, l_q, h, e = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _lib(BWD_LIB)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), _ptr(seed), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, h, l_q, k.shape[1], e, scale,
                            int(bool(causal)), thresh, inv_keep, _DTYPE_CODE[q.dtype],
                            stream)
    if err != 0:
        raise RuntimeError(f"bd_attention_bwd launch failed: cudaError {err}")
    bd_attention_bwd.launches += 1
    return dq, dk, dv


bd_attention_bwd.launches = 0


class _BdAttention(torch.autograd.Function):
    """The forward kernel with ``lse`` out; the backward kernel for the
    gradient (JAX ``custom_vjp`` ``_bd_attention``, ``bd_attention.py:299-330``)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, causal, scale, dropout):
        out, lse = bd_attention_fwd(q, k, v, seed, causal=causal, scale=scale,
                                    dropout=dropout, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.args = dict(causal=causal, scale=scale, dropout=dropout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seed = ctx.saved_tensors
        dq, dk, dv = bd_attention_bwd(q, k, v, out, do.contiguous(), lse, seed, **ctx.args)
        return dq, dk, dv, None, None, None, None


def bd_attention(q, k, v, *, causal: bool = False, scale: float | None = None,
                 dropout: float = 0.0, seed: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over ``[B, L, H, E]`` tensors (``E == D``), differentiable.

    ``dropout`` > 0 drops attention probabilities with the Philox mask of
    ``seed`` (a 1-element int64 tensor on q's device, see
    :func:`draw_seed`). When a gradient is needed the call goes through the
    forward kernel (saving ``lse``) and the backward kernel; otherwise only
    the forward kernel runs. Raises on a shape, dtype, layout or device the
    kernels do not take.
    """
    _check_shapes(q, k, v)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")
    if dropout > 0.0 and seed is None:
        raise ValueError("dropout > 0 needs a seed tensor (draw_seed)")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _BdAttention.apply(q, k, v, seed, bool(causal), scale, float(dropout))
    return bd_attention_fwd(q, k, v, seed, causal=causal, scale=scale, dropout=dropout,
                            with_lse=False)[0]
