"""Full and ProbSparse attention and the projection layer around them
(reference ``models/Informer/attn.py``; JAX counterpart ``models/attention.py``).

With ``attn="prob"`` an ``AttentionLayer`` runs :func:`prob_sparse_attention`
(torch ops, as the JAX package's is XLA work; no attention dropout, as in
JAX). It draws its ``index_sample`` from the ``generator`` passed to
``forward``, in train and in eval mode, before anything else of the call; with
no generator it takes the fixed draw of a generator seeded 0 (JAX's
``jax.random.key(0)`` fallback). Cross-attention is always ``attn="full"``.

With ``attn="ring"`` an ``AttentionLayer`` runs ``parallel/ring.py``'s
:func:`ring_attention` over its ``mesh``'s ``seq_axis`` (the encoder's
self-attention; JAX ``models/attention.py:268-278``): plain torch blocks, no
kernel and no attention dropout, forward and backward.

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

With ``dtype`` bfloat16 or float16 the projections compute in that dtype
(:class:`Dense`) and q, k, v reach every route in it: the kernels take them
as they are (f32 math inside, output in the dtype), and
:func:`full_attention` runs its einsums and softmax in it, as the JAX
package's XLA path does.
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
from ..parallel.ring import ring_attention
from ..parallel.tensor import column_parallel

NEG_INF = float(torch.finfo(torch.float32).min)


@functools.cache
def neg_inf(dtype: torch.dtype) -> float:
    """``NEG_INF`` rounded to ``dtype``: -inf in bf16 and f16, as JAX's cast
    gives (``masked_fill`` refuses a value the dtype cannot hold)."""
    return float(torch.tensor(NEG_INF).to(dtype))


def causal_mask(l_q: int, l_k: int, device=None) -> torch.Tensor:
    """Boolean ``[l_q, l_k]`` mask, True where attention is DISALLOWED (strict
    upper triangle), matching the reference's ``TriangularCausalMask``."""
    return torch.ones(l_q, l_k, dtype=torch.bool, device=device).triu(1)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: f32 parameters; x, the weight and the
    bias cast to the compute ``dtype``, then the product and the bias add in
    it. At float32 the casts are no-ops and this is ``nn.Linear``. With
    ``tp_group`` set (``parallel/tensor.py``) the weight holds this rank's
    output rows: the product runs column-parallel, the bias added after the
    gather."""

    tp_group = None

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp_group is not None:
            w = self.weight.to(dt)
            return (column_parallel(lambda x: F.linear(x, w), x.to(dt), self.tp_group)
                    + self.bias.to(dt))
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
    bf16 and f16 the masked scores are -inf: ``NEG_INF`` rounds to it, as in JAX
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


# ProbSparse layout switch (JAX ``models/attention.py:30-38``): within these
# limits the scores come from one dense [B, H, L_Q, L_K] product and the
# sampled and selected entries are gathered from it; beyond them keys are
# gathered per query, O(L * sample_k * E) in memory. Both give the same values.
DENSE_SCORES_MAX_LK = 2048
DENSE_SCORES_ELEM_BUDGET = 2 ** 29


def prob_sizes(l_q: int, l_k: int, factor: int) -> tuple[int, int]:
    """``(sample_k, n_top)``: keys sampled per query, ``min(factor *
    ceil(ln L_K), L_K)``, and queries kept, ``min(factor * ceil(ln L_Q), L_Q)``."""
    return (min(factor * math.ceil(math.log(l_k)), l_k),
            min(factor * math.ceil(math.log(l_q)), l_q))


def draw_index_sample(l_q: int, l_k: int, factor: int, generator: torch.Generator | None,
                      device) -> torch.Tensor:
    """The ``[L_Q, sample_k]`` key indices one ProbSparse call samples, shared
    by every batch row and head (JAX ``models/attention.py:112``), drawn on
    ``device`` from ``generator``, or from a generator seeded 0 when there
    is none."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sample_k, _ = prob_sizes(l_q, l_k, factor)
    return torch.randint(0, l_k, (l_q, sample_k), generator=generator, device=device)


def prob_sparse_attention(q, k, v, *, mask_flag: bool, factor: int,
                          index_sample: torch.Tensor, scale: Optional[float] = None,
                          dense_layout: Optional[bool] = None):
    """ProbSparse attention over ``[B, L, H, E]`` tensors (reference
    ``ProbAttention``, ``attn.py:85-187``; JAX ``models/attention.py:78-198``),
    value for value, in the inputs' dtype. Each query's sparsity measure
    ``M = max - sum / L_K`` over its ``index_sample`` keys picks the
    ``n_top`` queries that attend; the others keep the initial context, the
    mean of V (unmasked) or its cumulative sum (masked, which needs L_Q ==
    L_K), and the masked rows are the causal mask's rows at the kept
    queries. The queries are kept by a stable descending sort, so ties go
    to the lower index as in ``jax.lax.top_k``, and the result depends only
    on the set kept. ``dense_layout`` overrides the switch
    (``DENSE_SCORES_*``). Returns ``(out, None)``."""
    b, l_q, h, e = q.shape
    l_k = k.shape[1]
    sample_k, n_top = prob_sizes(l_q, l_k, factor)
    if tuple(index_sample.shape) != (l_q, sample_k):
        raise ValueError(f"index_sample must be [{l_q}, {sample_k}], got "
                         f"{list(index_sample.shape)}")
    q_, k_, v_ = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, E]
    d = v_.shape[-1]
    if dense_layout is None:
        dense_layout = (l_k <= DENSE_SCORES_MAX_LK
                        and b * h * l_q * l_k <= DENSE_SCORES_ELEM_BUDGET)
    if dense_layout:
        qk_full = torch.einsum("bhle,bhse->bhls", q_, k_)  # [B, H, L_Q, L_K]
        qk_sample = qk_full.gather(3, index_sample.expand(b, h, l_q, sample_k))
    else:
        k_sample = k_[:, :, index_sample]  # [B, H, L_Q, sample_k, E]
        qk_sample = torch.einsum("bhle,bhlse->bhls", q_, k_sample)
    m = qk_sample.amax(dim=-1) - qk_sample.sum(dim=-1) / l_k
    m_top = torch.sort(m, dim=-1, descending=True, stable=True).indices[..., :n_top]
    if dense_layout:
        scores = qk_full.gather(2, m_top[..., None].expand(b, h, n_top, l_k))
    else:
        q_reduce = q_.gather(2, m_top[..., None].expand(b, h, n_top, e))
        scores = torch.einsum("bhue,bhke->bhuk", q_reduce, k_)
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    scores = scores * scale
    if mask_flag:
        context = v_.cumsum(dim=-2)
        scores = scores.masked_fill(causal_mask(l_q, l_k, q.device)[m_top],
                                    neg_inf(scores.dtype))
    else:
        context = v_.mean(dim=-2, keepdim=True).expand(b, h, l_q, d)
    update = torch.einsum("bhuk,bhkd->bhud", torch.softmax(scores, dim=-1), v_)
    context = context.scatter(2, m_top[..., None].expand(b, h, n_top, d),
                              update.to(context.dtype))
    return context.transpose(1, 2), None


class AttentionLayer(nn.Module):
    """Q/K/V/output projections around the inner attention (reference
    ``AttentionLayer``, ``attn.py:190-221``). ``attn``: "full", "prob"
    (:func:`prob_sparse_attention` with ``factor``) or "ring"
    (:func:`ring_attention` over ``mesh``'s ``seq_axis``, which the call
    requires). ``mix=True`` keeps the
    reference's head/sequence transpose before the output projection.
    ``fuse_qkv`` (off under LSQ; JAX ``models/attention.py:252-262``): one
    ``qkv`` projection to 3·d for self-attention, which must be called with
    one tensor three times, or with ``cross`` a ``query`` projection and
    one ``kv`` to 2·d, which must be called with keys that are the values.
    ``lsq_nbits`` LSQ-quantizes the four projections (``lsq_fibbinary``:
    onto the fibbinary codebook). ``dtype``: the compute dtype of the
    projections, hence of q, k, v and the attention."""

    def __init__(self, d_model: int, n_heads: int, *, attn: str = "full",
                 mask_flag: bool = False, factor: int = 5, mix: bool = False,
                 output_attention: bool = False, use_pallas: bool = False,
                 fuse_qkv: bool = False, cross: bool = False, lsq_nbits: int | None = None,
                 lsq_fibbinary: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, mesh=None, seq_axis: str = "seq"):
        super().__init__()
        if attn not in ("full", "prob", "ring"):
            raise ValueError(f"attn must be 'full', 'prob' or 'ring', got {attn!r}")
        self.attn = attn
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.n_heads = n_heads
        self.mask_flag = mask_flag
        self.factor = factor
        self.mix = mix
        self.output_attention = output_attention
        self.use_pallas = use_pallas
        self.dropout = dropout
        self.fused = None
        d = (d_model // n_heads) * n_heads
        lsq = dict(lsq_nbits=lsq_nbits, lsq_fibbinary=lsq_fibbinary, use_pallas=use_pallas,
                   dtype=dtype)
        if fuse_qkv and lsq_nbits is None:
            self.fused = "kv" if cross else "qkv"
            if cross:
                self.query = Dense(d_model, d, dtype=dtype)
            setattr(self, self.fused, Dense(d_model, len(self.fused) * d, dtype=dtype))
        else:
            self.query = dense_layer(d_model, d, **lsq)
            self.key = dense_layer(d_model, d, **lsq)
            self.value = dense_layer(d_model, d, **lsq)
        self.out = dense_layer(d, d_model, **lsq)

    def _project(self, queries, keys, values):
        """q, k, v ``[B, L, d]``: through one fused projection where the
        layer has one (the identity of the inputs checked before any cast;
        the parts are strided views of its output)."""
        if self.fused == "qkv":
            if not (queries is keys and keys is values):
                raise ValueError("a fused qkv projection takes one tensor as queries, keys "
                                 "and values")
            return self.qkv(queries).chunk(3, dim=-1)
        if self.fused == "kv":
            if keys is not values:
                raise ValueError("a fused kv projection takes one tensor as keys and values")
            return (self.query(queries), *self.kv(keys).chunk(2, dim=-1))
        return self.query(queries), self.key(keys), self.value(values)

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        b, l, _ = queries.shape
        s = keys.shape[1]
        h = self.n_heads
        q, k, v = self._project(queries, keys, values)
        q, k, v = q.unflatten(-1, (h, -1)), k.unflatten(-1, (h, -1)), v.unflatten(-1, (h, -1))
        # q, k and v meet in their common dtype, as jnp.einsum promotes: int8
        # weight-only serving of a bf16 model returns a projection in its
        # input's dtype, which may be f32 (JAX serving.py:132).
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("attention dropout in train mode needs a torch.Generator")
        kernel = self.use_pallas and not self.output_attention
        if self.attn == "ring":
            if self.mesh is None:
                raise ValueError(f"attn='ring' requires a mesh with a '{self.seq_axis}' axis")
            out, attn = ring_attention(q, k, v, self.mesh, axis_name=self.seq_axis,
                                       causal=self.mask_flag), None
        elif self.attn == "prob":
            index_sample = draw_index_sample(l, s, self.factor, generator, q.device)
            out, attn = prob_sparse_attention(q, k, v, mask_flag=self.mask_flag,
                                              factor=self.factor, index_sample=index_sample)
        elif kernel and supported_shape(q, k, v):
            # The kernels take contiguous tensors: a fused projection's parts are copied.
            seed = draw_seed(generator, q.device) if drop > 0.0 else None
            out = bd_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=self.mask_flag, dropout=drop, seed=seed)
            attn = None
        elif kernel and not self.training:
            out = mha_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=self.mask_flag)
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
