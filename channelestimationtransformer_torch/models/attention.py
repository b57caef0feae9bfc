"""Full attention and the projection layer around it (reference
``models/Informer/attn.py``; JAX counterpart ``models/attention.py``).

Routing of ``AttentionLayer`` with ``attn="full"``:

- ``use_pallas=True`` and no attention maps requested: the hand-written
  kernel's wrapper (``ops/cuda/bd_attention.py``), which launches the CUDA
  kernel on CUDA tensors (raising on a shape it does not take) and runs its
  plain version on CPU tensors.
- otherwise: :func:`full_attention`, the plain torch counterpart of the JAX
  package's XLA path, kept as the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.cuda.bd_attention import bd_attention

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask(l_q: int, l_k: int, device=None) -> torch.Tensor:
    """Boolean ``[l_q, l_k]`` mask, True where attention is DISALLOWED (strict
    upper triangle), matching the reference's ``TriangularCausalMask``."""
    return torch.ones(l_q, l_k, dtype=torch.bool, device=device).triu(1)


def full_attention(q, k, v, *, mask_flag: bool, scale: Optional[float] = None,
                   return_attn: bool = False):
    """Dense softmax attention over ``[B, L, H, E]`` tensors, without
    dropout (reference ``FullAttention.forward``, ``attn.py:54-82``)."""
    e = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    scores = torch.einsum("blhe,bshe->bhls", q, k)
    if mask_flag:
        scores = scores.masked_fill(causal_mask(q.shape[1], k.shape[1], q.device), NEG_INF)
    a = torch.softmax(scale * scores, dim=-1)
    out = torch.einsum("bhls,bshd->blhd", a, v)
    return (out, a) if return_attn else (out, None)


class AttentionLayer(nn.Module):
    """Q/K/V/output projections around the inner attention (reference
    ``AttentionLayer``, ``attn.py:190-221``). ``mix=True`` keeps the
    reference's head/sequence transpose before the output projection."""

    def __init__(self, d_model: int, n_heads: int, *, attn: str = "full",
                 mask_flag: bool = False, mix: bool = False,
                 output_attention: bool = False, use_pallas: bool = False,
                 fuse_qkv: bool = False, lsq_nbits: int | None = None):
        super().__init__()
        if attn != "full":
            raise NotImplementedError(
                f"attn={attn!r} is not ported yet (ROADMAP Queue 1: ProbSparse "
                "attention, parallelism)")
        if fuse_qkv:
            raise NotImplementedError("fuse_qkv is not ported yet (ROADMAP Queue 1)")
        if lsq_nbits is not None:
            raise NotImplementedError("LSQ attention is not ported yet (ROADMAP Queue 1: "
                                      "LSQ and fibbinary)")
        self.n_heads = n_heads
        self.mask_flag = mask_flag
        self.mix = mix
        self.output_attention = output_attention
        self.use_pallas = use_pallas
        d = (d_model // n_heads) * n_heads
        self.query = nn.Linear(d_model, d)
        self.key = nn.Linear(d_model, d)
        self.value = nn.Linear(d_model, d)
        self.out = nn.Linear(d, d_model)

    def forward(self, queries, keys, values):
        b, l, _ = queries.shape
        s = keys.shape[1]
        h = self.n_heads
        q = self.query(queries).view(b, l, h, -1)
        k = self.key(keys).view(b, s, h, -1)
        v = self.value(values).view(b, s, h, -1)
        if self.use_pallas and not self.output_attention:
            out, attn = bd_attention(q, k, v, causal=self.mask_flag), None
        else:
            out, attn = full_attention(q, k, v, mask_flag=self.mask_flag,
                                       return_attn=self.output_attention)
        if self.mix:
            # Reference transposes [B, L, H, D] -> [B, H, L, D] then flattens,
            # interleaving heads with sequence (attn.py:216-218).
            out = out.transpose(1, 2)
        return self.out(out.reshape(b, l, -1)), attn
