"""Full attention and the projection layer around it (reference
``models/Informer/attn.py``; JAX counterpart ``models/attention.py``).

Routing of ``AttentionLayer`` with ``attn="full"`` (the counterpart of JAX
``models/attention.py:291-345``), first match wins:

1. ``use_pallas``, no attention maps, and ``bd_attention``'s
   ``supported_shape`` takes the shape: ``ops/cuda/bd_attention.py``, which
   launches the CUDA forward kernel, and the backward kernel when a gradient
   is needed, on CUDA tensors and runs their plain versions on CPU tensors.
2. ``use_pallas``, no attention maps, eval mode: the forward-only
   ``ops/cuda/mha_attention.py`` (the JAX package's ``mha_attention``), for
   the long or wide shapes route 1 does not take; CUDA kernel or plain
   version likewise.
3. otherwise: :func:`full_attention`, the plain torch counterpart of the JAX
   package's XLA path, kept as the reference. At training time it is the
   JAX package's own route for the shapes route 1 does not take.

The routes follow what the port's kernels take, not the TPU's VMEM budget,
and a CUDA tensor stands where JAX tests for a TPU backend.

In train mode with ``dropout`` > 0 routes 1 and 3 draw one seed per call
from the step's generator and drop attention probabilities with that
seed's Philox mask (``dropout_keep_mask``), so the two draw the same masks
from the same generator.

With ``dtype`` bfloat16 the projections compute in bf16 (:class:`Dense`)
and q, k, v reach every route in bf16: the kernels take them as they are
(f32 math inside, output in bf16), and :func:`full_attention` runs its
einsums and softmax in bf16, as the JAX package's XLA path does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.bd_attention import bd_attention, draw_seed, dropout_keep_mask, supported_shape
from ..ops.cuda.mha_attention import mha_attention
from ..ops.quant.lsq import DenseLSQ

NEG_INF = float(torch.finfo(torch.float32).min)


@functools.cache
def neg_inf(dtype: torch.dtype) -> float:
    """``NEG_INF`` rounded to ``dtype``: -inf in bf16, as JAX's cast gives
    (``masked_fill`` refuses a value the dtype cannot hold)."""
    return float(torch.tensor(NEG_INF).to(dtype))


def causal_mask(l_q: int, l_k: int, device=None) -> torch.Tensor:
    """Boolean ``[l_q, l_k]`` mask, True where attention is DISALLOWED (strict
    upper triangle), matching the reference's ``TriangularCausalMask``."""
    return torch.ones(l_q, l_k, dtype=torch.bool, device=device).triu(1)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: f32 parameters; x, the weight and the
    bias cast to the compute ``dtype``, then the product and the bias add in
    it. At float32 the casts are no-ops and this is ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def dense_layer(in_features: int, out_features: int, *, lsq_nbits: int | None = None,
                lsq_fibbinary: bool = False, use_pallas: bool = False,
                dtype: torch.dtype = torch.float32) -> nn.Linear:
    """A :class:`Dense`, or with ``lsq_nbits`` a :class:`DenseLSQ` whose
    fibbinary snap takes the CUDA kernel when ``use_pallas`` (JAX
    ``AttentionLayer._dense``, ``models/attention.py:233-241``), computing
    in ``dtype``."""
    if lsq_nbits is None:
        return Dense(in_features, out_features, dtype=dtype)
    return DenseLSQ(in_features, out_features, nbits=lsq_nbits, fibbinary=lsq_fibbinary,
                    use_pallas=use_pallas, dtype=dtype)


def full_attention(q, k, v, *, mask_flag: bool, scale: Optional[float] = None,
                   dropout: float = 0.0, generator: torch.Generator | None = None,
                   return_attn: bool = False):
    """Dense softmax attention over ``[B, L, H, E]`` tensors (reference
    ``FullAttention.forward``, ``attn.py:54-82``), in the inputs' dtype (in
    bf16 the masked scores are -inf: ``NEG_INF`` rounds to it, as in JAX
    ``models/attention.py:47-75``). With ``dropout`` > 0 the
    probabilities are dropped by the Philox mask of a seed drawn from
    ``generator`` and kept ones scaled by ``1 / (1 - dropout)`` (JAX
    ``models/attention.py:69-73``, which draws Bernoulli bits instead)."""
    b, l, h, e = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    scores = torch.einsum("blhe,bshe->bhls", q, k)
    if mask_flag:
        scores = scores.masked_fill(causal_mask(l, k.shape[1], q.device),
                                    neg_inf(scores.dtype))
    a = torch.softmax(scale * scores, dim=-1)
    a_dropped = a
    if dropout > 0.0:
        keep = dropout_keep_mask(draw_seed(generator, q.device), b, h, l, k.shape[1],
                                 1.0 - dropout)
        a_dropped = torch.where(keep, a / (1.0 - dropout), 0.0)
    out = torch.einsum("bhls,bshd->blhd", a_dropped, v)
    return (out, a) if return_attn else (out, None)


class AttentionLayer(nn.Module):
    """Q/K/V/output projections around the inner attention (reference
    ``AttentionLayer``, ``attn.py:190-221``). ``mix=True`` keeps the
    reference's head/sequence transpose before the output projection.
    ``lsq_nbits`` LSQ-quantizes the four projections (``lsq_fibbinary``:
    onto the fibbinary codebook). ``dtype``: the compute dtype of the
    projections, hence of q, k, v and the attention."""

    def __init__(self, d_model: int, n_heads: int, *, attn: str = "full",
                 mask_flag: bool = False, mix: bool = False,
                 output_attention: bool = False, use_pallas: bool = False,
                 fuse_qkv: bool = False, lsq_nbits: int | None = None,
                 lsq_fibbinary: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn != "full":
            raise NotImplementedError(
                f"attn={attn!r} is not ported yet (ROADMAP Queue 1: ProbSparse "
                "attention, parallelism)")
        if fuse_qkv:
            raise NotImplementedError("fuse_qkv is not ported yet (ROADMAP Queue 1)")
        self.n_heads = n_heads
        self.mask_flag = mask_flag
        self.mix = mix
        self.output_attention = output_attention
        self.use_pallas = use_pallas
        self.dropout = dropout
        d = (d_model // n_heads) * n_heads
        lsq = dict(lsq_nbits=lsq_nbits, lsq_fibbinary=lsq_fibbinary, use_pallas=use_pallas,
                   dtype=dtype)
        self.query = dense_layer(d_model, d, **lsq)
        self.key = dense_layer(d_model, d, **lsq)
        self.value = dense_layer(d_model, d, **lsq)
        self.out = dense_layer(d, d_model, **lsq)

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        b, l, _ = queries.shape
        s = keys.shape[1]
        h = self.n_heads
        q = self.query(queries).view(b, l, h, -1)
        k = self.key(keys).view(b, s, h, -1)
        v = self.value(values).view(b, s, h, -1)
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("attention dropout in train mode needs a torch.Generator")
        kernel = self.use_pallas and not self.output_attention
        if kernel and supported_shape(q, k, v):
            seed = draw_seed(generator, q.device) if drop > 0.0 else None
            out = bd_attention(q, k, v, causal=self.mask_flag, dropout=drop, seed=seed)
            attn = None
        elif kernel and not self.training:
            out = mha_attention(q, k, v, causal=self.mask_flag)
            attn = None
        else:
            out, attn = full_attention(q, k, v, mask_flag=self.mask_flag, dropout=drop,
                                       generator=generator,
                                       return_attn=self.output_attention)
        if self.mix:
            # Reference transposes [B, L, H, D] -> [B, H, L, D] then flattens,
            # interleaving heads with sequence (attn.py:216-218).
            out = out.transpose(1, 2)
        return self.out(out.reshape(b, l, -1)), attn
