"""The port's attention backward and dropout on the CPU.

- The backward's plain version, and the autograd ``Function`` around the
  kernels (whose CPU path is the plain versions), against ``jax.grad``
  through the JAX package's Pallas kernel in interpret mode, at dropout 0:
  rtol 2e-4 / atol 2e-5 (float32, as the Pallas kernel's own gradient test).
- The backward's plain version against torch autograd through the plain
  forward, with dropout and a fixed seed: rtol 1e-5 / atol 1e-6 (the same
  f32 formulas, summed in another order).
- ``dropout_keep_mask``: Random123's Philox4x32-10 known answers (exact),
  the keep rate within 5 sigma of 1 - p, kept probabilities scaled by
  exactly 1 / (1 - p), and the mask as a function of the seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.ops.pallas.bd_attention import bd_attention as jax_bd_attention

from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    _reference_forward,
    bd_attention,
    bd_attention_bwd,
    bd_attention_bwd_reference,
    bd_attention_fwd,
    bd_attention_reference,
    dropout_keep_mask,
    philox4x32_10,
)

# tests/test_pallas_kernels.py:173-196's shape (causal and not), then the
# flagship's cross-attention and shortest encoder shapes.
SHAPES = [
    (2, 30, 30, 4, 16, False),
    (2, 30, 30, 4, 16, True),
    (2, 15, 24, 8, 16, False),
    (4, 12, 12, 8, 16, False),
]


def _qkv(b, l_q, l_k, h, e, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l_q, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, e)).astype(np.float32),
            rng.normal(size=(b, l_k, h, e)).astype(np.float32))


def _seed(value=0x0123_4567_89AB_CDEF):
    return torch.tensor([value], dtype=torch.int64)


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.grad`` of sum(sin(bd_attention)) through the Pallas kernel."""
    cache = {}

    def grads(b, l_q, l_k, h, e, causal):
        key = (b, l_q, l_k, h, e, causal)
        if key not in cache:
            q, k, v = map(jnp.asarray, _qkv(b, l_q, l_k, h, e))

            def loss(q, k, v):
                return jnp.sum(jnp.sin(jax_bd_attention(q, k, v, causal=causal,
                                                        interpret=True)))
            cache[key] = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
        return cache[key]
    return grads


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
def test_backward_reference_matches_pallas_grad(jax_grads, b, l_q, l_k, h, e, causal):
    q, k, v = map(torch.from_numpy, _qkv(b, l_q, l_k, h, e))
    out, lse = _reference_forward(q, k, v, causal=causal, scale=e ** -0.5, dropout=0.0,
                                  seed=None, with_lse=True)
    before = bd_attention_bwd.launches
    got = bd_attention_bwd(q, k, v, out, torch.cos(out), lse, causal=causal, scale=e ** -0.5,
                           dropout=0.0)
    assert bd_attention_bwd.launches == before  # the CPU path launches nothing
    for g, w in zip(got, jax_grads(b, l_q, l_k, h, e, causal)):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
def test_autograd_function_matches_pallas_grad(jax_grads, b, l_q, l_k, h, e, causal):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(b, l_q, l_k, h, e))
    fwd, bwd = bd_attention_fwd.launches, bd_attention_bwd.launches
    torch.sin(bd_attention(q, k, v, causal=causal)).sum().backward()
    assert (bd_attention_fwd.launches, bd_attention_bwd.launches) == (fwd, bwd)
    for t, w in zip((q, k, v), jax_grads(b, l_q, l_k, h, e, causal)):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout", [0.05, 0.3])
def test_backward_reference_matches_autograd_with_dropout(causal, dropout):
    b, l_q, l_k, h, e = (2, 15, 15, 4, 16) if causal else (2, 15, 24, 4, 16)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(b, l_q, l_k, h, e, seed=12))
    seed = _seed()
    out = bd_attention_reference(q, k, v, causal=causal, dropout=dropout, seed=seed)
    do = torch.from_numpy(np.random.default_rng(13).normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (q, k, v), do)
    o, lse = _reference_forward(q.detach(), k.detach(), v.detach(), causal=causal,
                                scale=e ** -0.5, dropout=dropout, seed=seed, with_lse=True)
    got = bd_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o, do, lse, seed,
                                     causal=causal, dropout=dropout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # The autograd Function (the kernels' route) gives the same gradient.
    got_fn = torch.autograd.grad(
        bd_attention(q, k, v, causal=causal, dropout=dropout, seed=seed), (q, k, v), do)
    for g, w in zip(got_fn, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's published Philox4x32-10 test vectors."""
    words = philox4x32_10(*(torch.tensor(x, dtype=torch.int64) for x in counter + key))
    assert tuple(int(w) for w in words) == want


def test_keep_mask_rate_and_seed():
    b, h, l, p = 64, 8, 90, 0.05
    keep = dropout_keep_mask(_seed(), b, h, l, l, 1.0 - p)
    assert keep.shape == (b, h, l, l) and keep.dtype == torch.bool
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1.0 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(keep, dropout_keep_mask(_seed(), b, h, l, l, 1.0 - p))
    other = dropout_keep_mask(_seed(7), b, h, l, l, 1.0 - p)
    assert not torch.equal(keep, other)
    # Every (b, h) cell has its own counter: no two heads share a mask.
    assert not torch.equal(keep[0, 0], keep[0, 1]) and not torch.equal(keep[0, 0], keep[1, 0])
    # The mask at a smaller key length is the leading columns of the larger.
    assert torch.equal(dropout_keep_mask(_seed(), b, h, l, 37, 1.0 - p), keep[..., :37])


@pytest.mark.parametrize("causal", [False, True])
def test_kept_probabilities_scaled_by_inverse_keep(causal):
    """With one-hot values (E == l_k) the output is P_drop itself: kept
    probabilities times exactly 1 / (1 - p), dropped ones exactly 0."""
    b, l, h, p = 3, 16, 2, 0.3
    q, k, _ = map(torch.from_numpy, _qkv(b, l, l, h, 16, seed=14))
    v = torch.eye(l).view(1, l, 1, l).expand(b, l, h, l).contiguous()
    seed = _seed(99)
    out = bd_attention_reference(q, k, v, causal=causal, dropout=p, seed=seed)
    got = out.permute(0, 2, 1, 3)  # [B, H, Lq, Lk] = P_drop
    probs = bd_attention_reference(q, k, v, causal=causal).permute(0, 2, 1, 3)
    keep = dropout_keep_mask(seed, b, h, l, l, 1.0 - p)
    assert torch.equal(got, torch.where(keep, probs * (1.0 / (1.0 - p)), 0.0))
    assert (got[~keep] == 0).all()
