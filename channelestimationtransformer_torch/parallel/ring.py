"""Ring attention: exact attention with the sequence axis sharded over the
``seq`` mesh axis (JAX counterpart ``parallel/ring.py``), forward and
backward.

Every rank holds the whole ``[B, L, H, E]`` q, k and v (the encoder's input
is replicated). A rank keeps its own contiguous shard of L/P query rows,
and the K/V shards travel around the ring by point-to-point sends, shard
``j`` to rank ``j + 1`` each step, the order of JAX's ``ppermute`` ring
(``:68-70``). Each step merges one (Q-local, K-block) pair into a streaming
softmax (``:61-66``); the causal mask uses the global positions of both
blocks, the held K/V block having started at ring position
``(my - i) mod P`` (``:58-59``). The rank's output rows are then gathered
along L, so every rank returns the global ``[B, L, H, D]``.

The backward is what JAX's ``jax.grad`` makes of its ``ppermute`` scan,
written out as a :class:`torch.autograd.Function`. The forward keeps the
rank's query rows, its own K/V shard, its output rows and their row
log-sum-exp. The backward takes the rank's rows of the output gradient
(every rank's downstream is the same replicated computation, so the loss
counts once), then goes round the ring once more, all P steps: each step
recomputes the held block's probabilities ``exp(s - lse)`` with the
forward's offsets and adds its share to dQ, and to the dK / dV
accumulators that travel with the block, so each is back at its owner when
the ring closes. dQ, dK and dV are then gathered along L, as the inputs
were replicated.

The blocks are plain torch ops, as JAX's are ``einsum`` (XLA work).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NEG_INF = -1e30


def _block_scores(q, k, q_off: int, k_off: int, scale: float, causal: bool):
    """Scaled scores ``[B, Lq, H, Lk]`` of one (Q-local, K-block) pair,
    ``NEG_INF`` where the global causal mask forbids."""
    scores = torch.einsum("blhe,bshe->blhs", q, k) * scale
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        ki = k_off + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill((ki > qi)[None, :, None, :], NEG_INF)
    return scores


def _block_attend(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """Numerator ``[B, Lq, H, D]``, row max ``[B, Lq, H]`` and denominator
    ``[B, Lq, H]`` of one (Q-local, K-block) pair."""
    scores = _block_scores(q, k, q_off, k_off, scale, causal)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    return torch.einsum("blhs,bshd->blhd", e, v), m, e.sum(dim=-1)


def _rotate(tensors, to_rank: int, from_rank: int, group):
    """Send each of ``tensors`` to ``to_rank`` and receive the same shapes
    from ``from_rank`` (global ranks)."""
    new = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), to_rank, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, from_rank, group) for t in new])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return new


def _gather_l(t, group, p: int):
    """``t``'s shards of every rank of ``group``, concatenated along L."""
    if p == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(p)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _Ring:
    """The ring's geometry on this rank of ``group``."""

    def __init__(self, group, l: int, axis_name: str):
        self.group = group
        self.p, self.my = dist.get_world_size(group), dist.get_rank(group)
        if l % self.p:
            raise ValueError(f"sequence length {l} not divisible by the {axis_name!r} axis "
                             f"size {self.p}")
        self.l_loc = l // self.p
        self.mine = slice(self.my * self.l_loc, (self.my + 1) * self.l_loc)
        self.to_rank = dist.get_global_rank(group, (self.my + 1) % self.p)
        self.from_rank = dist.get_global_rank(group, (self.my - 1) % self.p)

    def offsets(self, i: int) -> tuple[int, int]:
        """Global offsets of the rank's rows and of the block held at step
        ``i`` (it started at ring position ``(my - i) mod P``)."""
        return self.my * self.l_loc, ((self.my - i) % self.p) * self.l_loc

    def rotate(self, tensors):
        return _rotate(tensors, self.to_rank, self.from_rank, self.group)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring: _Ring, scale: float, causal: bool):
        q_loc = q[:, ring.mine]
        k_own, v_own = k[:, ring.mine].contiguous(), v[:, ring.mine].contiguous()
        b, l_loc, h, _ = q_loc.shape
        num = q.new_zeros((b, l_loc, h, v.shape[-1]))
        m = q.new_full((b, l_loc, h), NEG_INF)
        denom = q.new_zeros((b, l_loc, h))
        k_cur, v_cur = k_own, v_own
        for i in range(ring.p):
            n_i, m_i, d_i = _block_attend(q_loc, k_cur, v_cur, *ring.offsets(i), scale, causal)
            new_m = torch.maximum(m, m_i)
            alpha, beta = torch.exp(m - new_m), torch.exp(m_i - new_m)
            num = num * alpha[..., None] + n_i * beta[..., None]
            denom = denom * alpha + d_i * beta
            m = new_m
            if i < ring.p - 1:  # JAX's scan also rotates after the last block; its result is unused
                k_cur, v_cur = ring.rotate([k_cur, v_cur])
        denom = torch.clamp_min(denom, 1e-30)
        out = num / denom[..., None]
        ctx.save_for_backward(q_loc, k_own, v_own, out, m + torch.log(denom))
        ctx.ring, ctx.scale, ctx.causal = ring, scale, causal
        return _gather_l(out, ring.group, ring.p)

    @staticmethod
    def backward(ctx, grad_out):
        q_loc, k_cur, v_cur, out, lse = ctx.saved_tensors
        ring, scale, causal = ctx.ring, ctx.scale, ctx.causal
        g = grad_out[:, ring.mine]
        delta = (g * out).sum(dim=-1)  # [B, Lq, H]
        dq = torch.zeros_like(q_loc)
        dk, dv = torch.zeros_like(k_cur), torch.zeros_like(v_cur)
        for i in range(ring.p):
            s = _block_scores(q_loc, k_cur, *ring.offsets(i), scale, causal)
            prob = torch.exp(s - lse[..., None])  # 0 where masked
            ds = prob * (torch.einsum("blhd,bshd->blhs", g, v_cur) - delta[..., None])
            dq = dq + scale * torch.einsum("blhs,bshe->blhe", ds, k_cur)
            dk = dk + scale * torch.einsum("blhs,blhe->bshe", ds, q_loc)
            dv = dv + torch.einsum("blhs,blhd->bshd", prob, g)
            # dK and dV travel with their block; after all P rotations every
            # accumulator is back at the rank that owns the block.
            if ring.p > 1:
                if i < ring.p - 1:
                    k_cur, v_cur, dk, dv = ring.rotate([k_cur, v_cur, dk, dv])
                else:
                    dk, dv = ring.rotate([dk, dv])
        return (*(_gather_l(t, ring.group, ring.p) for t in (dq, dk, dv)), None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh, *,
                   axis_name: str = "seq", causal: bool = False, scale=None) -> torch.Tensor:
    """Exact attention over ``[B, L, H, E]`` with L sharded over ``mesh``'s
    ``axis_name`` axis; L must divide by the axis size. Returns the global
    ``[B, L, H, D]`` output on every rank of the axis; under autograd its
    backward gives every rank the global dQ, dK and dV."""
    ring = _Ring(mesh.get_group(axis_name), q.shape[1], axis_name)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, ring, scale, causal)
