"""The port's mha_attention wrapper on the CPU: its plain version against the
JAX package's two Pallas kernels (``_attn_kernel_blhe`` and
``_attn_kernel_small``, ``ops/pallas/attention.py``) run through
``pl.pallas_call(..., interpret=True)``, built here as
``tests/test_pallas_kernels.py`` builds them; its launch counter; and the
inputs it refuses. The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: float32 rtol 2e-4 / atol 2e-5, as the Pallas kernels' own
tests; bfloat16 inputs are compared in float32 at 1e-2 (one bf16 rounding
of the result, 2^-8 relative).
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from channelestimationtransformer_tpu.ops.pallas.attention import (
    _attn_kernel_blhe,
    _attn_kernel_small,
)

from channelestimationtransformer_torch.ops.cuda.mha_attention import (
    mha_attention,
    mha_attention_fwd,
)

RTOL, ATOL = 2e-4, 2e-5


def _blhe_interpret(q, k, v, causal):
    """The ``[B, L, H, E]`` kernel, one grid cell per batch element
    (``attention.py:130-148``), l_q == l_k and D == E."""
    b, l, h, e = q.shape
    kernel = functools.partial(_attn_kernel_blhe, scale=1 / math.sqrt(e), causal=causal,
                               l_k=l, heads=h)
    return pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[pl.BlockSpec((1, l, h, e), lambda i: (i, 0, 0, 0))] * 3,
        out_specs=pl.BlockSpec((1, l, h, e), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, l, h, e), q.dtype),
        interpret=True,
    )(q, k, v)


def _small_interpret(q, k, v, causal, group=2):
    """The ``[B*H, L, E]`` kernel over groups of heads
    (``attention.py:153-190``), l_q != l_k and D != E allowed."""
    b, l_q, h, e = q.shape
    l_k, d = k.shape[1], v.shape[-1]
    bh = b * h
    kernel = functools.partial(_attn_kernel_small, scale=1 / math.sqrt(e), causal=causal,
                               l_q=l_q, l_k=l_k, group=group)
    out = pl.pallas_call(
        kernel,
        grid=(bh // group,),
        in_specs=[pl.BlockSpec((group, l_q, e), lambda i: (i, 0, 0)),
                  pl.BlockSpec((group, l_k, e), lambda i: (i, 0, 0)),
                  pl.BlockSpec((group, l_k, d), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((group, l_q, d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, l_q, d), q.dtype),
        interpret=True,
    )(*(jnp.swapaxes(t, 1, 2).reshape(bh, t.shape[1], t.shape[3]) for t in (q, k, v)))
    return jnp.swapaxes(out.reshape(b, h, l_q, d), 1, 2)


def _qkv(b, l_q, l_k, h, e, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l_q, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, d)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    before = mha_attention_fwd.launches
    out = mha_attention(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)), causal=causal)
    assert mha_attention_fwd.launches == before  # the CPU path launches nothing
    assert out.dtype == dtype
    return out.float().numpy()


# (b, l, h, e, causal): the flagship's heads, then E 128 (the xl model), and
# key lengths past the bd kernel's 128.
BLHE_SHAPES = [
    (2, 12, 2, 16, False),
    (2, 12, 2, 16, True),
    (2, 32, 2, 128, False),
    (2, 15, 2, 128, True),
    (2, 160, 2, 128, False),
    (1, 200, 2, 64, True),
]


@pytest.mark.parametrize("b,l,h,e,causal", BLHE_SHAPES)
def test_matches_blhe_kernel_interpret(b, l, h, e, causal):
    q, k, v = _qkv(b, l, l, h, e, e, seed=l + e)
    want = np.asarray(_blhe_interpret(*map(jnp.asarray, (q, k, v)), causal))
    np.testing.assert_allclose(_port(q, k, v, causal), want, rtol=RTOL, atol=ATOL)


# (b, l_q, l_k, h, e, d, causal): the xl model's cross-attention, then l_q
# != l_k with D != E, a causal mask with l_q > l_k and l_q < l_k (top-left:
# key j kept for query i iff j <= i), and E 128 with l_k > 128.
SMALL_SHAPES = [
    (2, 15, 64, 2, 128, 128, False),
    (2, 20, 150, 2, 32, 16, False),
    (2, 33, 17, 2, 24, 40, True),
    (2, 17, 45, 2, 16, 8, True),
    (1, 130, 200, 2, 128, 64, True),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,d,causal", SMALL_SHAPES)
def test_matches_small_kernel_interpret(b, l_q, l_k, h, e, d, causal):
    q, k, v = _qkv(b, l_q, l_k, h, e, d, seed=l_q + l_k)
    want = np.asarray(_small_interpret(*map(jnp.asarray, (q, k, v)), causal))
    np.testing.assert_allclose(_port(q, k, v, causal), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l_q,l_k,causal", [(40, 40, True), (15, 64, False)])
def test_bfloat16_inputs_match_in_float32(l_q, l_k, causal):
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16).float().numpy()
               for t in _qkv(2, l_q, l_k, 2, 128, 128, seed=5))
    want = np.asarray(_small_interpret(*map(jnp.asarray, (q, k, v)), causal))
    np.testing.assert_allclose(_port(q, k, v, causal, torch.bfloat16), want,
                               rtol=1e-2, atol=1e-2)


def test_explicit_scale():
    q, k, v = _qkv(2, 9, 9, 2, 16, 16, seed=6)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(mha_attention(tq, tk, tv, scale=0.5),
                               mha_attention(2 * tq, tk, tv, scale=0.25))


def _zeros(l_q, l_k, e, d, b=(2, 2), h=(2, 2), dtype=torch.float32, device="cpu"):
    return (torch.zeros(b[0], l_q, h[0], e, dtype=dtype, device=device),
            torch.zeros(b[1], l_k, h[1], e, dtype=dtype, device=device),
            torch.zeros(b[1], l_k, h[1], d, dtype=dtype, device=device))


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(l_q=8, l_k=8, e=136, d=136), ValueError, "128"),
    (dict(l_q=8, l_k=8, e=64, d=129), ValueError, "128"),
    (dict(l_q=0, l_k=8, e=64, d=64), ValueError, "non-empty"),
    (dict(l_q=8, l_k=0, e=64, d=64), ValueError, "non-empty"),
    (dict(l_q=8, l_k=8, e=64, d=64, b=(2, 3)), ValueError, "B, H and E"),
    (dict(l_q=8, l_k=8, e=64, d=64, h=(2, 1)), ValueError, "B, H and E"),
    (dict(l_q=8, l_k=8, e=64, d=64, dtype=torch.float64), TypeError, "float32"),
    (dict(l_q=8, l_k=8, e=64, d=64, device="meta"), ValueError, "cpu or cuda"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(kwargs, error, match):
    with pytest.raises(error, match=match):
        mha_attention(*_zeros(**kwargs))


def test_wrapper_raises_under_autograd():
    q, k, v = _zeros(8, 8, 64, 64)
    with pytest.raises(RuntimeError, match="forward only"):
        mha_attention(q, k, v.requires_grad_())
    with torch.no_grad():
        assert torch.isfinite(mha_attention(q, k, v)).all()
