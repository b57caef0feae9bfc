"""The bf16 datapath of the bd attention kernels, emulated on the CPU.

``csrc/bd_attention_fwd.cu`` and ``csrc/bd_attention_bwd.cu`` run bf16 inputs
through bf16 MMAs (m16n8k16, f32 accumulation; ``csrc/mma_tf32.cuh``):

- products of two bf16 inputs are exact in f32: S = Q·Kᵀ in both kernels,
  dP = dO·Vᵀ in the backward;
- a computed f32 operand is split into bf16 hi = bf16(x) and
  lo = bf16(x - hi) (nearest even, as ``__floats2bfloat162_rn``) for its
  product, two MMAs: P for P·V in the forward, dS for dQ = dS·K and
  dK = dSᵀ·Q and P_drop for dV = P_dropᵀ·dO in the backward. One
  rounding, as the TPU's MXU rounds its operands at default precision,
  misses the tolerance at the training batch (B 256, the decoder's causal
  L 15, pinned below): of dS in dQ and of P_drop in dV, and of P in the
  backward fed by the forward's output, against the plain backward on the
  plain forward's;
- the softmax (row max, the row sum of the unrounded P), lse,
  D = rowsum(dO∘O) and the 1/keep scaling stay f32; each result is rounded
  to bf16 once.

Here that arithmetic is written in torch (a float32 matmul of bf16 values
reproduces the MMA up to the order of its sums), with the keep masks of
``dropout_keep_mask`` injected, at the flagship's attention shapes (B 2,
H 8, E 16: self-attention at L 90, 45, 23 and 12, the decoder's causal 15,
the cross 15 x 24) and at E 20 (the plain-load route) and E 64 (the widest
head). It is held to two references on the same bf16 inputs:

- the plain versions (``_reference_forward``, ``bd_attention_bwd_reference``:
  f32 math, one rounding of the result), with dropout 0 and 0.05: forward
  rtol/atol 1e-2 (lse 1e-5: S is exact, as in the plain version's f32),
  backward ``BWD_TOL["bfloat16"]`` (1e-2, 1e-2);
- JAX's ``bd_attention`` and its ``jax.vjp`` through the Pallas kernels in
  interpret mode (f32 dots, results in bf16), at dropout 0, since the two
  RNG streams cannot match: the same tolerances.

With the splits every case stays within about half of its tolerance at
B 256 too.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.ops.pallas.bd_attention import bd_attention as jax_bd_attention

from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    _reference_forward,
    bd_attention_bwd_reference,
    dropout_keep_mask,
)

FWD_TOL = (1e-2, 1e-2)
LSE_TOL = (1e-5, 1e-5)
BWD_TOL = {"bfloat16": (1e-2, 1e-2)}
B, H = 2, 8

# (l_q, l_k, causal, E): the flagship's six attention shapes, then E 20 (rows
# of 40 bytes: plain loads) and E 64.
SHAPES = [
    (90, 90, False, 16),
    (45, 45, False, 16),
    (23, 23, False, 16),
    (12, 12, False, 16),
    (15, 15, True, 16),
    (15, 24, False, 16),
    (23, 23, True, 20),
    (128, 128, False, 64),
]
SEED = 0x0BF1_6D47


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread (many small ops; restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and held in f32."""
    return x.to(torch.bfloat16).float()


def _inputs(l_q, l_k, e, b=B, seed=None):
    """q, k, v and dO as bf16 tensors, drawn with numpy."""
    rng = np.random.default_rng(7 * l_q + l_k + e if seed is None else seed)
    shapes = ((b, l_q, H, e), (b, l_k, H, e), (b, l_k, H, e), (b, l_q, H, e))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                 for s in shapes)


def _valid(l_q, l_k, causal):
    return (~torch.ones(l_q, l_k, dtype=torch.bool).triu(1) if causal
            else torch.ones(l_q, l_k, dtype=torch.bool))


def _keep(l_q, l_k, dropout, b=B, value=SEED):
    if not dropout:
        return None, None
    seed = torch.tensor([value], dtype=torch.int64)
    return seed, dropout_keep_mask(seed, b, H, l_q, l_k, 1.0 - dropout)


def split_mm(a, b):
    """a @ b with a split into bf16 hi + lo, the small product first (the
    kernels' mma_split_bf16; b holds bf16 values)."""
    hi = bf16(a)
    return bf16(a - hi) @ b + hi @ b


def one_pass_mm(a, b):
    return bf16(a) @ b


def bf16_forward(q, k, v, causal, scale, keep, dropout, mm=split_mm):
    """The forward kernel's bf16 datapath: S = Q K^T exact, the one-pass
    softmax in f32, O = P_drop V (P_drop split into bf16 hi + lo, ``mm``)
    times (1/keep_prob) / rowsum(P); lse = max + log(rowsum(P)). Output
    rounded to bf16, lse f32."""
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * scale
    s = s.masked_fill(~_valid(q.shape[1], k.shape[1], causal), -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(-1, keepdim=True)
    inv = 1.0
    if dropout > 0.0:
        p = torch.where(keep, p, 0.0)
        inv = 1.0 / (1.0 - dropout)
    out = mm(p, vh) * (inv / total)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16), (m + torch.log(total))[..., 0]


def bf16_backward(q, k, v, o, do, lse, keep, causal, scale, dropout, mm=split_mm):
    """The backward kernel's bf16 datapath: S and dP exact, P from lse, the
    1/keep scaling and D = rowsum(dO * O) in f32, dS and P_drop split into
    bf16 hi + lo for dQ = dS K, dK = dS^T Q and dV = P_drop^T dO (``mm``).
    Results in bf16."""
    qh, kh, vh, oh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, o, do))
    valid = _valid(q.shape[1], k.shape[1], causal)
    s = qh @ kh.transpose(-1, -2)
    dp = doh @ vh.transpose(-1, -2)
    p = torch.where(valid, torch.exp(s * scale - lse[..., None]), 0.0)
    p_drop = p
    if dropout > 0.0:
        kept = valid & keep
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(kept, dp * inv_keep, 0.0)
        p_drop = torch.where(kept, p * inv_keep, 0.0)
    d = (doh * oh).sum(-1, keepdim=True)
    ds = p * (dp - d) * scale
    dq = mm(ds, kh)
    dk = mm(ds.transpose(-1, -2), qh)
    dv = mm(p_drop.transpose(-1, -2), doh)
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (dq, dk, dv))


def _close(got, want, tol):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def test_bf16_rounding_is_nearest_even():
    """``bf16`` rounds as the kernels' ``pack_bf16`` (``__floats2bfloat162_rn``):
    to nearest, ties to the even mantissa."""
    ulp = 2.0 ** -7  # of values in [1, 2)
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 2 + 2.0 ** -20, -(1 + ulp / 2),
                      1 + ulp / 4])
    want = torch.tensor([1.0, 1 + 2 * ulp, 1 + ulp, -1.0, 1.0])
    assert torch.equal(bf16(x), want)


@pytest.mark.parametrize("l_q,l_k,causal,e", SHAPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_bf16_forward_matches_the_plain_version(l_q, l_k, causal, e, dropout):
    q, k, v, _ = _inputs(l_q, l_k, e)
    seed, keep = _keep(l_q, l_k, dropout)
    scale = e ** -0.5
    got, got_lse = bf16_forward(q, k, v, causal, scale, keep, dropout)
    want, want_lse = _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                                        seed=seed, with_lse=True)
    _close(got, want, FWD_TOL)
    torch.testing.assert_close(got_lse, want_lse, rtol=LSE_TOL[0], atol=LSE_TOL[1])


@pytest.mark.parametrize("l_q,l_k,causal,e", SHAPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_bf16_backward_matches_the_plain_version(l_q, l_k, causal, e, dropout):
    """The backward on the emulated forward's output and lse (as the kernels
    chain), against the plain backward on the same."""
    q, k, v, do = _inputs(l_q, l_k, e)
    seed, keep = _keep(l_q, l_k, dropout)
    scale = e ** -0.5
    o, lse = bf16_forward(q, k, v, causal, scale, keep, dropout)
    got = bf16_backward(q, k, v, o, do, lse, keep, causal, scale, dropout)
    want = bd_attention_bwd_reference(q, k, v, o, do, lse, seed, causal=causal, scale=scale,
                                      dropout=dropout)
    for g, w in zip(got, want):
        _close(g, w, BWD_TOL["bfloat16"])


@pytest.fixture(scope="module")
def pallas():
    """JAX's ``bd_attention`` through the Pallas kernels in interpret mode on
    the bf16 inputs: the output and ``jax.vjp``'s dQ, dK, dV for the same dO,
    as bf16 torch tensors."""
    cache = {}

    def run(l_q, l_k, causal, e):
        key = (l_q, l_k, causal, e)
        if key not in cache:
            q, k, v, do = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                           for t in _inputs(l_q, l_k, e))
            out, vjp = jax.vjp(
                lambda q, k, v: jax_bd_attention(q, k, v, causal=causal, interpret=True),
                q, k, v)
            cache[key] = [torch.from_numpy(np.asarray(t, dtype=np.float32)).to(torch.bfloat16)
                          for t in (out, *vjp(do))]
        return cache[key]
    return run


@pytest.mark.parametrize("l_q,l_k,causal,e", SHAPES)
def test_bf16_forward_matches_pallas(pallas, l_q, l_k, causal, e):
    q, k, v, _ = _inputs(l_q, l_k, e)
    got, _ = bf16_forward(q, k, v, causal, e ** -0.5, None, 0.0)
    _close(got, pallas(l_q, l_k, causal, e)[0], FWD_TOL)


@pytest.mark.parametrize("l_q,l_k,causal,e", SHAPES)
def test_bf16_backward_matches_pallas_vjp(pallas, l_q, l_k, causal, e):
    q, k, v, do = _inputs(l_q, l_k, e)
    scale = e ** -0.5
    o, lse = bf16_forward(q, k, v, causal, scale, None, 0.0)
    got = bf16_backward(q, k, v, o, do, lse, None, causal, scale, 0.0)
    for g, w in zip(got, pallas(l_q, l_k, causal, e)[1:]):
        _close(g, w, BWD_TOL["bfloat16"])


def _worst(got, want, tol):
    """max |got - want| / (atol + rtol |want|): above 1 misses the tolerance."""
    return max(((g.float() - w.float()).abs() / (tol[1] + tol[0] * w.float().abs())).max().item()
               for g, w in zip(got, want))


def test_one_bf16_rounding_of_ds_and_p_drop_misses_the_backward_tolerance():
    """Why the backward splits dS and P_drop: at the decoder's causal L 15
    with the training batch (B 256), dropout 0.05, one bf16 rounding of dS
    puts dQ and one of P_drop puts dV outside rtol/atol 1e-2 of the plain
    backward; the split keeps all three within about half of it."""
    b, l, e, dropout = 256, 15, 16, 0.05
    q, k, v, do = _inputs(l, l, e, b=b, seed=5030)
    seed, keep = _keep(l, l, dropout, b=b, value=82)
    scale = e ** -0.5
    o, lse = bf16_forward(q, k, v, True, scale, keep, dropout)
    want = bd_attention_bwd_reference(q, k, v, o, do, lse, seed, causal=True, scale=scale,
                                      dropout=dropout)
    tol = BWD_TOL["bfloat16"]
    one = bf16_backward(q, k, v, o, do, lse, keep, True, scale, dropout, mm=one_pass_mm)
    assert _worst(one[:1], want[:1], tol) > 1.0  # dQ
    assert _worst(one[2:], want[2:], tol) > 1.0  # dV
    split = bf16_backward(q, k, v, o, do, lse, keep, True, scale, dropout)
    assert _worst(split, want, tol) < 0.6


def test_one_bf16_rounding_of_p_misses_the_chained_backward_tolerance():
    """Why the forward splits P: one rounding keeps the forward's own output
    within its tolerance, but the backward fed by that output and lse (the
    kernels' chain) then misses rtol/atol 1e-2 of the plain backward fed by
    the plain forward's (B 256, causal L 15, dropout 0.05); with P split,
    the chain stays within about half of it."""
    b, l, e, dropout = 256, 15, 16, 0.05
    q, k, v, do = _inputs(l, l, e, b=b, seed=3030)
    seed, keep = _keep(l, l, dropout, b=b, value=80)
    scale = e ** -0.5
    kw = dict(causal=True, scale=scale, dropout=dropout)
    plain_o, plain_lse = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    want = bd_attention_bwd_reference(q, k, v, plain_o, do, plain_lse, seed, **kw)
    tol = BWD_TOL["bfloat16"]
    worst = {}
    for name, mm in (("one pass", one_pass_mm), ("split", split_mm)):
        o, lse = bf16_forward(q, k, v, True, scale, keep, dropout, mm=mm)
        assert _worst((o,), (plain_o,), FWD_TOL) < 0.6
        got = bf16_backward(q, k, v, o, do, lse, keep, True, scale, dropout)
        worst[name] = _worst(got, want, tol)
    assert worst["one pass"] > 1.0 and worst["split"] < 0.6
