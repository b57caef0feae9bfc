"""The port's attention kernel wrapper on the CPU: its plain version against
the JAX package's Pallas kernel in interpret mode, its launch counter, and
the shapes it refuses. The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance rtol 2e-4 / atol 2e-5 (float32, as the Pallas kernel's own tests).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from channelestimationtransformer_tpu.ops.pallas.bd_attention import bd_attention as jax_bd_attention

from channelestimationtransformer_torch.models.attention import full_attention
from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    bd_attention,
    bd_attention_reference,
    supported_shape,
)

# The shapes of tests/test_pallas_kernels.py:146-153, then the flagship's
# cross-attention and shortest encoder shapes.
SHAPES = [
    (4, 90, 90, 8, 16, False),
    (4, 15, 15, 8, 16, True),
    (2, 15, 24, 8, 16, False),
    (4, 45, 45, 4, 32, False),
    (3, 15, 24, 8, 16, False),
    (4, 12, 12, 8, 16, False),
]


def _qkv(b, l_q, l_k, h, e, seed=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l_q, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, e)).astype(np.float32))


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
def test_cpu_path_matches_pallas_interpret(b, l_q, l_k, h, e, causal):
    q, k, v = _qkv(b, l_q, l_k, h, e)
    want = np.asarray(jax_bd_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert supported_shape(tq, tk, tv)
    before = bd_attention.launches
    got = bd_attention(tq, tk, tv, causal=causal)
    assert bd_attention.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_full_attention(causal):
    """The kernel's plain version and the model's plain full_attention agree
    (masking with -inf and with finfo.min give the same softmax)."""
    q, k, v = map(torch.from_numpy, _qkv(2, 15, 15, 4, 16, seed=3))
    want, _ = full_attention(q, k, v, mask_flag=causal)
    torch.testing.assert_close(bd_attention_reference(q, k, v, causal=causal), want,
                               rtol=2e-6, atol=2e-6)


def test_reference_keeps_bfloat16_output_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in map(torch.from_numpy, _qkv(2, 9, 9, 2, 16)))
    out = bd_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), bd_attention_reference(q.float(), k.float(), v.float(), causal=True),
        rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("l_q,l_k,e,d", [(16, 129, 16, 16), (16, 16, 16, 8), (513, 16, 16, 16),
                                         (16, 16, 80, 80)])
def test_wrapper_raises_on_unsupported_shape(l_q, l_k, e, d):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, l_q, 2, e)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, l_k, 2, e)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, l_k, 2, d)).astype(np.float32))
    assert not supported_shape(q, k, v)
    with pytest.raises(ValueError):
        bd_attention(q, k, v)


def test_wrapper_raises_on_other_devices():
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bd_attention(q, q, q)
