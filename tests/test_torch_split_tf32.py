"""The arithmetic of the tensor-core attention kernels, emulated on the CPU.

``csrc/mha_attention_fwd.cu`` and ``csrc/bd_attention_bwd.cu`` run every f32
product on the tensor cores as TF32 MMAs. TF32 keeps 10 mantissa bits, so
each f32 operand is split, x = hi + lo with hi = tf32(x) and lo = x - hi
truncated to TF32, and a product takes three passes,
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, with f32 accumulation
(``csrc/mma_tf32.cuh``). Here ``to_tf32`` (round to nearest, ties away
from zero, at 10 mantissa bits, as ``cvt.rna.tf32.f32``) and the split
product are written in torch, and the kernels' orders of work are replayed
on the plain versions' inputs:

- the forward (S = Q·Kᵀ, softmax, P·V) at an ``xl``-like shape and the xl
  cross shape, within the f32 kernel tolerance (rtol 1e-4 / atol 1e-5) of
  ``mha_attention_reference``;
- the backward in the kernel's order (S and dP once, dS materialised,
  dQ = dS·K, dK = dSᵀ·Q, dV = P_dropᵀ·dO) at the flagship shapes with the
  keep mask injected, within the backward tolerance (2e-4 / 2e-5) of
  ``bd_attention_bwd_reference``;
- one TF32 pass per product misses 1e-4 / 1e-5 at L 256 / E 128: the
  reason for the split;
- the bd forward (``csrc/bd_attention_fwd.cu``) in its order (S once over
  all keys, an exact one-pass softmax, P·V on the dropped P, the sum and
  1/keep_prob applied last, lse = max + log(sum)) at the flagship's L 90,
  its causal 15 and L 128 / E 64, with and without dropout, within the f32
  forward tolerance of ``_reference_forward`` (output and lse).

TF32 products are exact in f32 (11 x 11 significant bits), so a float32
matmul of TF32 values reproduces the MMA up to the order of the sums.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    _reference_forward,
    bd_attention_bwd_reference,
    dropout_keep_mask,
)
from channelestimationtransformer_torch.ops.cuda.mha_attention import mha_attention_reference

FWD_TOL = (1e-4, 1e-5)
BWD_TOL = (2e-4, 2e-5)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32: nearest at 10 mantissa bits, ties away from
    zero (add half of the dropped 13 bits' range to the magnitude, clear
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """x = hi + lo: hi rounded, lo = x - hi (exact) truncated to TF32, as the
    tensor core reads it."""
    hi = to_tf32(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_split(a, b):
    """a @ b at f32 accuracy from three TF32 products, small ones first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_one_pass(a, b):
    return to_tf32(a) @ to_tf32(b)


def _mask(l_q, l_k, causal):
    return torch.ones(l_q, l_k, dtype=torch.bool).triu(1) if causal else None


def attention_forward(q, k, v, causal, mm):
    """The forward kernel's arithmetic over [B, L, H, E]: scores and P·V by
    ``mm``, the softmax in f32."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = _mask(q.shape[1], k.shape[1], causal)
    if mask is not None:
        s = s.masked_fill(mask, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = mm(p, vh) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _qkv(b, l_q, l_k, h, e, seed):
    rng = np.random.default_rng(seed)
    return _randn(rng, b, l_q, h, e), _randn(rng, b, l_k, h, e), _randn(rng, b, l_k, h, e)


# (b, h, l_q, l_k, E, causal): the xl encoder's longest call, B and H cut to
# 2, and the xl cross and decoder shapes.
FWD_SHAPES = [
    (2, 2, 256, 256, 128, False),
    (2, 2, 256, 256, 128, True),
    (2, 2, 15, 64, 128, False),
    (2, 2, 15, 64, 128, True),
]


@pytest.mark.parametrize("b,h,l_q,l_k,e,causal", FWD_SHAPES)
def test_split_tf32_forward_within_the_f32_tolerance(b, h, l_q, l_k, e, causal):
    q, k, v = _qkv(b, l_q, l_k, h, e, seed=l_q + l_k + causal)
    got = attention_forward(q, k, v, causal, mm_split)
    want = mha_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=FWD_TOL[0], atol=FWD_TOL[1])


def test_one_tf32_pass_misses_the_f32_tolerance():
    q, k, v = _qkv(2, 256, 256, 2, 128, seed=256 + 256)
    want = mha_attention_reference(q, k, v)
    assert not torch.allclose(attention_forward(q, k, v, False, mm_one_pass), want,
                              rtol=FWD_TOL[0], atol=FWD_TOL[1])
    assert torch.allclose(attention_forward(q, k, v, False, mm_split), want,
                          rtol=FWD_TOL[0], atol=FWD_TOL[1])


def attention_backward(q, k, v, o, do, lse, keep, causal, scale, dropout):
    """The backward kernel's order of work: S and dP once each, P, P_drop
    and dS materialised, dQ = dS K, dK = dS^T Q, dV = P_drop^T dO, every
    product split-TF32."""
    qh, kh, vh, oh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, o, do))
    s = mm_split(qh, kh.transpose(-1, -2))
    dp = mm_split(doh, vh.transpose(-1, -2))
    valid = torch.ones_like(s, dtype=torch.bool)
    mask = _mask(q.shape[1], k.shape[1], causal)
    if mask is not None:
        valid = valid & ~mask
    p = torch.where(valid, torch.exp(s * scale - lse[..., None]), 0.0)
    p_drop = p
    if dropout > 0.0:
        kept = valid & keep
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(kept, dp * inv_keep, 0.0)
        p_drop = torch.where(kept, p * inv_keep, 0.0)
    d = (doh * oh).sum(-1, keepdim=True)
    ds = p * (dp - d) * scale
    dq = mm_split(ds, kh)
    dk = mm_split(ds.transpose(-1, -2), qh)
    dv = mm_split(p_drop.transpose(-1, -2), doh)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


# The flagship's attention calls (H 8, E 16), B cut to 4.
BWD_SHAPES = [
    (90, 90, False),
    (45, 45, False),
    (23, 23, False),
    (12, 12, False),
    (15, 15, True),
    (15, 24, False),
]


@pytest.mark.parametrize("l_q,l_k,causal", BWD_SHAPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_split_tf32_backward_within_the_backward_tolerance(l_q, l_k, causal, dropout):
    b, h, e = 4, 8, 16
    q, k, v = _qkv(b, l_q, l_k, h, e, seed=3 * l_q + l_k)
    do = _randn(np.random.default_rng(l_q), b, l_q, h, e)
    scale = e ** -0.5
    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64) if dropout else None
    o, lse = _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                                seed=seed, with_lse=True)
    keep = dropout_keep_mask(seed, b, h, l_q, l_k, 1.0 - dropout) if dropout else None
    got = attention_backward(q, k, v, o, do, lse, keep, causal, scale, dropout)
    want = bd_attention_bwd_reference(q, k, v, o, do, lse, seed, causal=causal, scale=scale,
                                      dropout=dropout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=BWD_TOL[0], atol=BWD_TOL[1])


def bd_forward(q, k, v, causal, scale, keep, dropout):
    """The bd forward kernel's order of work: S = Q K^T once (split-TF32),
    row max and sum over every key, P_drop = keep * P, O = P_drop V
    (split-TF32) times (1/keep_prob) / sum; lse = max + log(sum)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = mm_split(qh, kh.transpose(-1, -2)) * scale
    mask = _mask(q.shape[1], k.shape[1], causal)
    if mask is not None:
        s = s.masked_fill(mask, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(-1, keepdim=True)
    inv = 1.0
    if dropout > 0.0:
        p = torch.where(keep, p, 0.0)
        inv = 1.0 / (1.0 - dropout)
    out = mm_split(p, vh) * (inv / total)
    return out.permute(0, 2, 1, 3), (m + torch.log(total))[..., 0]


# (b, h, l_q, l_k, E, causal): the flagship's longest call and its causal
# decoder call (B cut to 4), and the widest case the kernel takes.
BD_FWD_SHAPES = [
    (4, 8, 90, 90, 16, False),
    (4, 8, 15, 15, 16, True),
    (2, 2, 128, 128, 64, False),
]


@pytest.mark.parametrize("b,h,l_q,l_k,e,causal", BD_FWD_SHAPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_split_tf32_bd_forward_within_the_f32_tolerance(b, h, l_q, l_k, e, causal, dropout):
    q, k, v = _qkv(b, l_q, l_k, h, e, seed=5 * l_q + e)
    scale = e ** -0.5
    seed = torch.tensor([0x0BD0_F0D5], dtype=torch.int64) if dropout else None
    keep = dropout_keep_mask(seed, b, h, l_q, l_k, 1.0 - dropout) if dropout else None
    got, got_lse = bd_forward(q, k, v, causal, scale, keep, dropout)
    want, want_lse = _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                                        seed=seed, with_lse=True)
    torch.testing.assert_close(got, want, rtol=FWD_TOL[0], atol=FWD_TOL[1])
    torch.testing.assert_close(got_lse, want_lse, rtol=FWD_TOL[0], atol=FWD_TOL[1])
