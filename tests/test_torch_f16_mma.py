"""The float16 datapath of the bd attention kernels, emulated on the CPU.

``csrc/bd_attention_fwd.cu`` and ``csrc/bd_attention_bwd.cu`` run float16
inputs through f16 MMAs (m16n8k16, f32 accumulation; ``csrc/mma_tf32.cuh``):

- products of two f16 inputs are exact in f32 (11 significant bits a
  factor): S = Q·Kᵀ in both kernels, dP = dO·Vᵀ in the backward;
- a computed f32 operand is rounded to f16 once (nearest even, subnormals
  kept, as ``__floats2half2_rn``) for its product, one MMA: P for P·V in
  the forward, dS for dQ = dS·K and dK = dSᵀ·Q and P_drop for
  dV = P_dropᵀ·dO in the backward. P and P_drop lie in [0, 1 / keep_prob];
- dS does not keep to f16's range. In training it is the product of small
  cotangents with P: at the flagship's batch of 256 the attention
  cotangents are ~1e-5 (a CPU run of the f16 flagship puts their mean at
  4e-5 at batch 32, and the loss's mean divides them by the batch), and dS
  falls below f16's normal range (2^-14) into its subnormals, down to the
  last (2^-24), where one rounding keeps few bits or none. So the backward
  multiplies each slab's dS by sc, a power of two (exact), before it
  rounds it, and dQ and dK by 1/sc after the products. sc takes the bound
  ``m = scale * max_i |dO_i|_1 * (inv_keep * max |V| + max_i |O_i|_inf)``
  on |dS| into [2^14, 2^15) (:func:`ds_scale`);
- the softmax (row max, the row sum of the unrounded P), lse,
  D = rowsum(dO∘O) and the 1/keep scaling stay f32; each result is rounded
  to f16 once.

Here that arithmetic is written in torch (a float32 matmul of f16 values
reproduces the MMA up to the order of its sums), with the keep masks of
``dropout_keep_mask`` injected, at the flagship's attention shapes and at
E 20 and 64 (``tests/test_torch_bf16_mma.py``'s ``SHAPES``). It is held to
the plain versions (``_reference_forward``, ``bd_attention_bwd_reference``:
f32 math, one rounding of the result) at the float16 tolerances of
``chip_smoke.py``: forward rtol/atol 2e-3 (lse 1e-5), backward 4e-3; and
to JAX's ``bd_attention`` and its ``jax.vjp`` through the Pallas kernels
in interpret mode (f32 dots, results in f16) at dropout 0.

At the training batch (B 256, L 90 and the decoder's causal L 15) the
forward stays within 0.4 of its tolerance and the backward chained on it
within 0.7 of the plain pair's, and with dO of a training
step's size (2^-17) the backward's f32 results, before their last rounding,
stay within a tenth of it relative to each gradient's max, where an
unscaled dS puts dQ and dK at 2-9x the tolerance.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from channelestimationtransformer_tpu.ops.pallas.bd_attention import bd_attention as jax_bd_attention

from channelestimationtransformer_torch.ops.cuda import bd_attention as bd_module
from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    _reference_forward,
    bd_attention_bwd_reference,
)

import test_torch_bf16_mma
from test_torch_bf16_mma import SHAPES, _keep, _valid, _worst, one_torch_thread  # noqa: F401

FWD_TOL = (2e-3, 2e-3)  # chip_smoke.py's TOL["float16"]
LSE_TOL = (1e-5, 1e-5)
BWD_TOL = (4e-3, 4e-3)  # chip_smoke.py's BWD_TOL["float16"]
B, H = 2, 8
TRAIN_DO = 2.0 ** -17  # a training step's attention cotangents at batch 256


_MASKS = {}


@pytest.fixture(autouse=True)
def masks_once(monkeypatch):
    """``dropout_keep_mask`` computed once per (seed, shape, keep_prob) in
    this module: the emulation, the plain versions and ``_keep`` ask for
    the same masks, and a Philox mask at B 256, L 90 takes seconds."""
    real = bd_module.dropout_keep_mask

    def cached(seed, *args):
        key = (int(seed.reshape(())), *args)
        if key not in _MASKS:
            _MASKS[key] = real(seed, *args)
        return _MASKS[key]
    monkeypatch.setattr(bd_module, "dropout_keep_mask", cached)
    monkeypatch.setattr(test_torch_bf16_mma, "dropout_keep_mask", cached)


def f16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to f16 (nearest even, subnormals kept) and held in f32."""
    return x.to(torch.float16).float()


def _inputs(l_q, l_k, e, b=B, seed=None, do_scale=1.0):
    """q, k, v and dO (times ``do_scale``) as f16 tensors, drawn with numpy."""
    rng = np.random.default_rng(7 * l_q + l_k + e if seed is None else seed)
    shapes = ((b, l_q, H, e), (b, l_k, H, e), (b, l_k, H, e), (b, l_q, H, e))
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    out[3] *= np.float32(do_scale)
    return tuple(torch.from_numpy(t).to(torch.float16) for t in out)


def ds_scale(m: torch.Tensor) -> torch.Tensor:
    """``bd_attention_bwd.cu:ds_scale``: the power of two that takes m into
    [2^14, 2^15), within 2^+-120; 1 where m is 0 or not finite."""
    _, e = torch.frexp(m)  # m = f * 2^e, f in [0.5, 1): ilogb(m) = e - 1
    sc = torch.exp2((14 - (e - 1)).clamp(-120, 120).float())
    return torch.where((m > 0) & torch.isfinite(m), sc, torch.ones_like(m))


def ds_bound(doh, vh, oh, scale, inv_keep):
    """The kernel's bound on |dS| for each (b, h), one slab: ``[B, H, 1, 1]``."""
    m = (scale * doh.abs().sum(-1).amax(-1)
         * (inv_keep * vh.abs().amax((-1, -2)) + oh.abs().amax((-1, -2))))
    return m[..., None, None]


def f16_forward(q, k, v, causal, scale, keep, dropout):
    """The forward kernel's f16 datapath: S = Q K^T exact, the one-pass
    softmax in f32, O = f16(P_drop) V times (1/keep_prob) / rowsum(P);
    lse = max + log(rowsum(P)). Output rounded to f16, lse f32."""
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
    out = (f16(p) @ vh) * (inv / total)
    return out.permute(0, 2, 1, 3).to(torch.float16), (m + torch.log(total))[..., 0]


def f16_backward(q, k, v, o, do, lse, keep, causal, scale, dropout, scaled=True, rounded=True):
    """The backward kernel's f16 datapath: S and dP exact, P from lse, the
    1/keep scaling and D in f32; dS times sc (``scaled``; else 1) and P_drop
    rounded to f16 once for dQ = dS K / sc, dK = dS^T Q / sc and
    dV = P_drop^T dO. Results in f16 (``rounded``) or in f32 before that."""
    qh, kh, vh, oh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, o, do))
    valid = _valid(q.shape[1], k.shape[1], causal)
    s = qh @ kh.transpose(-1, -2)
    dp = doh @ vh.transpose(-1, -2)
    p = torch.where(valid, torch.exp(s * scale - lse[..., None]), 0.0)
    p_drop, inv_keep = p, 1.0
    if dropout > 0.0:
        kept = valid & keep
        inv_keep = 1.0 / (1.0 - dropout)
        dp = torch.where(kept, dp * inv_keep, 0.0)
        p_drop = torch.where(kept, p * inv_keep, 0.0)
    d = (doh * oh).sum(-1, keepdim=True)
    sc = ds_scale(ds_bound(doh, vh, oh, scale, inv_keep)) if scaled else torch.ones(())
    ds = p * (dp - d) * (scale * sc)
    assert ds.abs().max() < 2.0 ** 15  # within f16's range (65504)
    dq = (f16(ds) @ kh) / sc
    dk = (f16(ds).transpose(-1, -2) @ qh) / sc
    dv = f16(p_drop).transpose(-1, -2) @ doh
    out = tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
    return tuple(t.to(torch.float16) for t in out) if rounded else out


def _close(got, want, tol):
    assert got.dtype == want.dtype == torch.float16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def _worst_of_max(got, want, tol):
    """max |got - want| / (atol * max|want| + rtol |want|) over the tensors:
    ``_worst`` relative to each tensor's max, for results of any size."""
    return max(((g.float() - w.float()).abs()
                / (tol[1] * w.float().abs().max() + tol[0] * w.float().abs())).max().item()
               for g, w in zip(got, want))


def test_f16_rounding_is_nearest_even_and_keeps_subnormals():
    """``f16`` rounds as the kernels' ``pack_f16`` (``__floats2half2_rn``):
    to nearest, ties to even, in the normal range and among subnormals."""
    ulp, sub = 2.0 ** -10, 2.0 ** -24  # of [1, 2); the smallest subnormal
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 3 * sub / 2, sub / 2,
                      sub / 2 + 2.0 ** -30, 70000.0])
    want = torch.tensor([1.0, 1 + 2 * ulp, -1.0, 2 * sub, 0.0, sub, math.inf])
    assert torch.equal(f16(x), want)


def test_ds_scale_is_a_power_of_two_into_its_interval():
    m = torch.tensor([1.0, 3e-9, 2.0 ** 14, 2.0 ** 15 - 1, 7e4, 1e-40, 0.0, math.inf])
    sc = ds_scale(m)
    assert torch.equal(torch.frexp(sc)[0], torch.full_like(sc, 0.5))  # powers of two
    top = (m * sc)[:5]
    assert ((top >= 2.0 ** 14) & (top < 2.0 ** 15)).all()
    assert sc[5] == 2.0 ** 120 and sc[6] == sc[7] == 1.0


@pytest.mark.parametrize("l_q,l_k,causal,e", SHAPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_f16_forward_and_backward_match_the_plain_versions(l_q, l_k, causal, e, dropout):
    """The forward against the plain forward; the backward on the emulated
    forward's output and lse (as the kernels chain) against the plain
    backward on the same."""
    q, k, v, do = _inputs(l_q, l_k, e)
    seed, keep = _keep(l_q, l_k, dropout)
    scale = e ** -0.5
    o, lse = f16_forward(q, k, v, causal, scale, keep, dropout)
    want, want_lse = _reference_forward(q, k, v, causal=causal, scale=scale, dropout=dropout,
                                        seed=seed, with_lse=True)
    _close(o, want, FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL[0], atol=LSE_TOL[1])
    got = f16_backward(q, k, v, o, do, lse, keep, causal, scale, dropout)
    want = bd_attention_bwd_reference(q, k, v, o, do, lse, seed, causal=causal, scale=scale,
                                      dropout=dropout)
    for g, w in zip(got, want):
        _close(g, w, BWD_TOL)


@pytest.mark.parametrize("l_q,l_k,causal,e", [SHAPES[0], SHAPES[4], SHAPES[7]])
def test_f16_datapath_matches_pallas_and_its_vjp(l_q, l_k, causal, e):
    """JAX's ``bd_attention`` through the Pallas kernels in interpret mode on
    the same f16 inputs (f32 inside, f16 out) and its ``jax.vjp`` for the
    same dO, at dropout 0: the forward's and the backward's tolerances."""
    import jax

    q, k, v, do = _inputs(l_q, l_k, e)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.float16) for t in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b, c: jax_bd_attention(a, b, c, causal=causal, interpret=True),
                       jq, jk, jv)
    want = [torch.from_numpy(np.asarray(t, dtype=np.float32)).to(torch.float16)
            for t in (out, *vjp(jdo))]
    assert out.dtype == jnp.float16
    scale = e ** -0.5
    o, lse = f16_forward(q, k, v, causal, scale, None, 0.0)
    _close(o, want[0], FWD_TOL)
    for g, w in zip(f16_backward(q, k, v, o, do, lse, None, causal, scale, 0.0), want[1:]):
        _close(g, w, BWD_TOL)


@pytest.mark.parametrize("l,causal", [(90, False), (15, True)])
def test_f16_datapath_at_the_training_batch(l, causal):
    """B 256, dropout 0.05: the forward within 0.4 of its tolerance (0.24 at
    L 90, 0.32 at L 15: one f16 rounding of the output is 2^-11 relative
    either side); the backward chained on it within 0.7 of its tolerance of
    the plain pair (the plain backward on the plain forward's output and
    lse; 0.61 at L 15 here, 0.16-0.45 over six other seeds and the
    flagship's other shapes)."""
    b, e, dropout = 256, 16, 0.05
    q, k, v, do = _inputs(l, l, e, b=b, seed=5030 + l)
    seed, keep = _keep(l, l, dropout, b=b, value=80 + l)
    scale = e ** -0.5
    kw = dict(causal=causal, scale=scale, dropout=dropout)
    plain_o, plain_lse = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    o, lse = f16_forward(q, k, v, causal, scale, keep, dropout)
    assert _worst((o,), (plain_o,), FWD_TOL) < 0.4
    got = f16_backward(q, k, v, o, do, lse, keep, causal, scale, dropout)
    want = bd_attention_bwd_reference(q, k, v, plain_o, do, plain_lse, seed, **kw)
    assert _worst(got, want, BWD_TOL) < 0.7


@pytest.mark.parametrize("l,causal", [(90, False), (15, True)])
def test_unscaled_ds_misses_the_tolerance_at_a_training_steps_cotangents(l, causal):
    """Why the backward scales dS: with dO of a training step's size (2^-17)
    at B 256, an unscaled dS rounded to f16 puts dQ and dK outside their
    tolerance of the plain backward's f32 results (relative to each
    gradient's max, before the last rounding to f16); scaled by sc they
    stay within a tenth of it, as at dO of unit size."""
    b, e, dropout = 256, 16, 0.05
    q, k, v, do = _inputs(l, l, e, b=b, seed=5030 + l, do_scale=TRAIN_DO)
    seed, keep = _keep(l, l, dropout, b=b, value=80 + l)
    scale = e ** -0.5
    o, lse = f16_forward(q, k, v, causal, scale, keep, dropout)
    want = bd_attention_bwd_reference(*(t.float() for t in (q, k, v, o, do)), lse, seed,
                                      causal=causal, scale=scale, dropout=dropout)
    args = (q, k, v, o, do, lse, keep, causal, scale, dropout)
    unscaled = f16_backward(*args, scaled=False, rounded=False)
    assert min(_worst_of_max((g,), (w,), BWD_TOL) for g, w in zip(unscaled[:2], want)) > 1.5
    assert _worst_of_max(f16_backward(*args, rounded=False), want, BWD_TOL) < 0.1
