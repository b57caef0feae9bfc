"""Ring attention: exact attention with the sequence axis sharded over the
``seq`` mesh axis (JAX counterpart ``parallel/ring.py``), forward only.

Every rank holds the whole ``[B, L, H, E]`` q, k and v (the encoder's input
is replicated). A rank keeps its own contiguous shard of L/P query rows,
and the K/V shards travel around the ring by point-to-point sends, shard
``j`` to rank ``j + 1`` each step, the order of JAX's ``ppermute`` ring
(``:68-70``). Each step merges one (Q-local, K-block) pair into a streaming
softmax (``:61-66``); the causal mask uses the global positions of both
blocks, the held K/V block having started at ring position
``(my - i) mod P`` (``:58-59``). The rank's output rows are then gathered
along L, so every rank returns the global ``[B, L, H, D]``.

The blocks are plain torch ops, as JAX's are ``einsum`` (XLA work). Its
backward (a second rotation) is not ported: under autograd this raises
``NotImplementedError`` (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NEG_INF = -1e30


def _block_attend(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """Numerator ``[B, Lq, H, D]``, row max ``[B, Lq, H]`` and denominator
    ``[B, Lq, H]`` of one (Q-local, K-block) pair."""
    scores = torch.einsum("blhe,bshe->blhs", q, k) * scale
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        ki = k_off + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill((ki > qi)[None, :, None, :], NEG_INF)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    return torch.einsum("blhs,bshd->blhd", e, v), m, e.sum(dim=-1)


def _rotate(k, v, to_rank: int, from_rank: int, group):
    """Send ``k`` and ``v`` to ``to_rank`` and receive the same shapes from
    ``from_rank`` (global ranks)."""
    k_new, v_new = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, to_rank, group), dist.P2POp(dist.isend, v, to_rank, group),
           dist.P2POp(dist.irecv, k_new, from_rank, group),
           dist.P2POp(dist.irecv, v_new, from_rank, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_new, v_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh, *,
                   axis_name: str = "seq", causal: bool = False, scale=None) -> torch.Tensor:
    """Exact attention over ``[B, L, H, E]`` with L sharded over ``mesh``'s
    ``axis_name`` axis; L must divide by the axis size. Returns the global
    ``[B, L, H, D]`` output on every rank of the axis."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring attention is forward-only: its backward is not ported (ROADMAP Queue 1 "
            "item 13); train with attn='full'")
    group = mesh.get_group(axis_name)
    p, my = dist.get_world_size(group), dist.get_rank(group)
    b, l, h, _ = q.shape
    if l % p:
        raise ValueError(f"sequence length {l} not divisible by the {axis_name!r} axis size {p}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    l_loc = l // p
    mine = slice(my * l_loc, (my + 1) * l_loc)
    q_loc, k_cur, v_cur = q[:, mine], k[:, mine].contiguous(), v[:, mine].contiguous()
    num = q.new_zeros((b, l_loc, h, v.shape[-1]))
    m = q.new_full((b, l_loc, h), NEG_INF)
    denom = q.new_zeros((b, l_loc, h))
    to_rank = dist.get_global_rank(group, (my + 1) % p)
    from_rank = dist.get_global_rank(group, (my - 1) % p)
    for i in range(p):
        src = (my - i) % p  # ring position the held K/V shard started at
        n_i, m_i, d_i = _block_attend(q_loc, k_cur, v_cur, my * l_loc, src * l_loc, scale, causal)
        new_m = torch.maximum(m, m_i)
        alpha, beta = torch.exp(m - new_m), torch.exp(m_i - new_m)
        num = num * alpha[..., None] + n_i * beta[..., None]
        denom = denom * alpha + d_i * beta
        m = new_m
        if i < p - 1:  # JAX's scan also rotates after the last block; its result is unused
            k_cur, v_cur = _rotate(k_cur, v_cur, to_rank, from_rank, group)
    out = num / torch.clamp_min(denom, 1e-30)[..., None]
    if p == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(p)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=1)
