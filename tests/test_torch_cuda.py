"""The CUDA kernels (bd-attention forward, with and without dropout, and
backward; the mha-attention forward on both its routes; fixed-point
quantization and the nearest-codeword snap, plain and in its LSQ mode; the
circular k=3 convolution's forward and gradients) against their plain
versions, on the card.

Marked ``cuda``; each test skips when no card is present. This file imports
only torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: forward float32 rtol 1e-4 / atol 1e-5 (the kernel sums in
another order than the plain version's matmuls, both in f32); backward
float32 rtol 2e-4 / atol 2e-5 (longer sums: dK and dV run over up to 512
query rows); bfloat16 is checked in its own dtype against the plain version
on the same bf16 inputs, rtol/atol 1e-2 (one bf16 rounding of the result,
2^-8 relative), float16 likewise at 2e-3 forward and 4e-3 backward (one
f16 rounding is 2^-11 relative). The dropout mask is compared exactly: both run the same
Philox. The quantization kernels are compared bit for bit: each rounding
step is one float32 operation in both, and stochastic rounding draws the
same Philox bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    _reference_forward,
    bd_attention,
    bd_attention_bwd,
    bd_attention_bwd_reference,
    bd_attention_fwd,
    bd_attention_reference,
    dropout_keep_mask,
)
from channelestimationtransformer_torch.ops.cuda import mha_attention as mha_module
from channelestimationtransformer_torch.ops.cuda.mha_attention import (
    mha_attention,
    mha_attention_fwd,
    mha_attention_reference,
    mha_route,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, l_q, l_k, h, e, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b, l, h, e, generator=g, device=device).to(dtype)
                 for l in (l_q, l_k, l_k))


SHAPES = [
    (256, 90, 90, 8, 16, False),
    (256, 15, 15, 8, 16, True),
    (256, 15, 24, 8, 16, False),
    (4, 45, 45, 4, 32, False),    # d_model sweep: E = 32
    (2, 128, 128, 2, 64, True),   # largest E: dynamic shared memory > 48 KB
    (2, 512, 100, 2, 24, False),  # long query tiled over the warps; E not a power of two
    (3, 1, 1, 1, 1, True),
]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# (rtol, atol) of a 16-bit result against the plain version's, rounded to its dtype.
TOL16 = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (2e-3, 2e-3)}
BWD_TOL16 = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (4e-3, 4e-3)}


def _seed(device, value=0x1234_5678_9ABC):
    return torch.tensor([value], dtype=torch.int64, device=device)


def _assert_close(got, want, dtype, tol=(1e-4, 1e-5), tol16=TOL16):
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
    else:
        rtol, atol = tol16[dtype]
        torch.testing.assert_close(got, want.to(dtype), rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, causal, dtype):
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda)
    before = bd_attention_fwd.launches
    got = bd_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert bd_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = bd_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    _assert_close(got, want, dtype)


def test_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 8, 8, 2, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        bd_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        bd_attention(q[:, ::2], k[:, ::2].contiguous(), v[:, ::2].contiguous())
    with pytest.raises(ValueError, match="device and dtype"):
        bd_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        bd_attention(q, k[:, :1].expand(2, 200, 2, 16).contiguous(),
                     v[:, :1].expand(2, 200, 2, 16).contiguous())
    assert np.isfinite(bd_attention(q, k, v).cpu().numpy()).all()
    with pytest.raises(ValueError, match="seed"):
        bd_attention(q, k, v, dropout=0.1)
    with pytest.raises(ValueError, match="seed"):
        bd_attention(q, k, v, dropout=0.1, seed=_seed("cpu"))


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_with_dropout_matches_plain_version(cuda, b, l_q, l_k, h, e, causal, dtype):
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=1)
    seed = _seed(cuda)
    got, lse = bd_attention_fwd(q, k, v, seed, causal=causal, scale=e ** -0.5, dropout=0.05,
                                with_lse=True)
    want, want_lse = _reference_forward(q.float(), k.float(), v.float(), causal=causal,
                                        scale=e ** -0.5, dropout=0.05, seed=seed,
                                        with_lse=True)
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", [(256, 90, 90, 8, 16, False),
                                                  (256, 15, 15, 8, 16, True),
                                                  (2, 512, 100, 2, 24, False),
                                                  (2, 129, 127, 3, 32, True),
                                                  (3, 17, 16, 5, 8, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_dropout_mask_is_the_plain_mask(cuda, b, l_q, l_k, h, e, causal, dtype):
    """The kernel's mask read back through one-hot values: with V's row j
    the unit vector of column j - e*g, output column c of pass g is
    P_drop[:, e*g + c], nonzero exactly where the key is kept (in bf16 too:
    a kept probability stays nonzero in bf16)."""
    q, k, _ = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=2)
    seed = _seed(cuda, 987654321)
    kept = torch.zeros(b, h, l_q, l_k, dtype=torch.bool, device=cuda)
    for g in range(0, l_k, e):
        v = torch.zeros(b, l_k, h, e, device=cuda, dtype=dtype)
        cols = torch.arange(g, min(g + e, l_k), device=cuda)
        v[:, cols, :, cols - g] = 1.0
        out = bd_attention(q, k, v, causal=causal, dropout=0.3, seed=seed)
        kept[..., g:g + e] = (out.permute(0, 2, 1, 3) != 0)[..., :len(cols)]
    want = dropout_keep_mask(seed, b, h, l_q, l_k, 0.7)
    if causal:
        want &= ~torch.ones(l_q, l_k, dtype=torch.bool, device=cuda).triu(1)
    assert torch.equal(kept, want)


# The tensor-core forward's edges: l_q 1, 17 (a second row tile with one
# row), 128, 129 (a second slab) and 512 (four slabs); l_k 1, 16, 17, 127 and
# 128 (each key width NK); E 8, 16, 20 (plain loads), 32 and 64; H 3 and 5
# (a block's last head group short of its heads).
FWD_EDGE_SHAPES = [
    (3, 1, 1, 2, 8, False),
    (2, 17, 16, 3, 16, True),
    (2, 128, 17, 2, 20, False),
    (2, 129, 127, 3, 32, True),
    (1, 512, 128, 2, 64, True),
    (2, 17, 128, 5, 16, False),
    (2, 512, 1, 2, 64, False),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", FWD_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_forward_kernel_tiling_edges(cuda, b, l_q, l_k, h, e, causal, dtype, dropout):
    """Output and lse against the plain version; two calls give the same bits."""
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=11)
    seed = _seed(cuda) if dropout else None
    kw = dict(causal=causal, scale=e ** -0.5, dropout=dropout)
    got, lse = bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
    again, lse_again = bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse_again)
    want, want_lse = _reference_forward(q.float(), k.float(), v.float(), seed=seed,
                                        with_lse=True, **kw)
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_backward_fed_by_the_forward_kernel_matches_the_plain_pair(cuda):
    """The backward kernel on the forward kernel's output and lse against
    the plain backward on the plain forward's, at the flagship's L 90 with
    dropout: the tensor-core lse keeps the backward within its tolerance."""
    q, k, v = _qkv(64, 90, 90, 8, 16, torch.float32, cuda, seed=12)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(13),
                     device=cuda)
    seed = _seed(cuda)
    kw = dict(causal=False, scale=0.25, dropout=0.05)
    o, lse = bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
    got = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    o_ref, lse_ref = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    want = bd_attention_bwd_reference(q, k, v, o_ref, do, lse_ref, seed, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_backward_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, causal, dtype,
                                               dropout):
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=3)
    seed = _seed(cuda) if dropout else None
    o, lse = _reference_forward(q, k, v, causal=causal, scale=e ** -0.5, dropout=dropout,
                                seed=seed, with_lse=True)
    o = o.contiguous()
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(dtype)
    before = bd_attention_bwd.launches
    got = bd_attention_bwd(q, k, v, o, do, lse, seed, causal=causal, scale=e ** -0.5,
                           dropout=dropout)
    torch.cuda.synchronize()
    assert bd_attention_bwd.launches == before + 1
    want = bd_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), do.float(),
                                      lse, seed, causal=causal, dropout=dropout)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype, tol=(2e-4, 2e-5), tol16=BWD_TOL16)


# The tensor-core backward's edges: E 8, 32 and 64 at L 128 (one query slab,
# eight key warps), a single row and key, L 17 (two row tiles, the second
# with one row), and l_q < l_k with E 20 (pad columns).
BWD_EDGE_SHAPES = [
    (2, 128, 128, 2, 8, False),
    (2, 128, 128, 2, 32, True),
    (2, 128, 128, 2, 64, False),
    (3, 1, 1, 2, 16, False),
    (3, 17, 17, 2, 16, True),
    (2, 17, 100, 3, 20, False),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", BWD_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_backward_kernel_tiling_edges(cuda, b, l_q, l_k, h, e, causal, dtype, dropout):
    test_backward_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, causal, dtype, dropout)


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_kernel_is_deterministic(cuda, dtype):
    """Each gradient element is summed by one warp in a fixed order (no
    atomics): two calls on the same inputs give the same bits."""
    q, k, v = _qkv(64, 90, 90, 8, 16, dtype, cuda, seed=8)
    seed = _seed(cuda)
    kw = dict(causal=False, scale=0.25, dropout=0.05)
    o, lse = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    o = o.contiguous()
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda).to(dtype)
    first = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    second = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The flagship's six attention shape classes (B 256, H 8, E 16).
FLAGSHIP_SHAPES = [(256, l_q, l_k, 8, 16, causal)
                   for l_q, l_k, causal in ((90, 90, False), (45, 45, False), (23, 23, False),
                                            (12, 12, False), (15, 15, True), (15, 24, False))]


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", FLAGSHIP_SHAPES)
def test_bf16_kernels_with_dropout_match_plain_versions_at_flagship_shapes(
        cuda, b, l_q, l_k, h, e, causal):
    """The bf16 datapath (bf16 MMAs; P, dS and P_drop split into bf16 hi +
    lo for their products) at a training step's shapes, dropout 0.05: the forward
    and its lse against the plain forward, and the backward on the kernel
    forward's output and lse against the plain backward on the same."""
    _check_16bit_training_kernels(cuda, b, l_q, l_k, h, e, causal, torch.bfloat16)


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", FLAGSHIP_SHAPES)
@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** -17])
def test_f16_kernels_with_dropout_match_plain_versions_at_flagship_shapes(
        cuda, b, l_q, l_k, h, e, causal, do_scale):
    """The f16 datapath (f16 MMAs; P, dS and P_drop rounded to f16 once,
    dS scaled by a power of two first) as the bf16 test, with dO of unit
    size and of a training step's size (2^-17: dS below f16's normal range
    unscaled), the backward held to its tolerance relative to each
    gradient's max."""
    _check_16bit_training_kernels(cuda, b, l_q, l_k, h, e, causal, torch.float16, do_scale)


def _check_16bit_training_kernels(cuda, b, l_q, l_k, h, e, causal, dtype, do_scale=1.0):
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=20 + l_q)
    do = (do_scale * torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(21),
                                 device=cuda)).to(dtype)
    seed = _seed(cuda)
    kw = dict(causal=causal, scale=e ** -0.5, dropout=0.05)
    o, lse = bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
    want, want_lse = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    _assert_close(o, want, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    if dtype == torch.bfloat16:
        want = bd_attention_bwd_reference(q, k, v, o, do, lse, seed, **kw)
        for g, w in zip(got, want):
            _assert_close(g, w, dtype)
        return
    # float16: relative to each gradient's max, since at dO 2^-17 the results
    # are f16 subnormals, whose one rounding is up to 2^-25 absolute.
    want = bd_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), do.float(),
                                      lse, seed, **kw)
    rtol, atol = BWD_TOL16[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        top = w.abs().max()
        torch.testing.assert_close(g.float() / top, w / top, rtol=rtol, atol=atol)


def test_autograd_through_the_kernels_matches_plain_autograd(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(64, 45, 45, 8, 16, torch.float32, cuda,
                                                seed=5))
    seed = _seed(cuda)
    fwd, bwd = bd_attention_fwd.launches, bd_attention_bwd.launches
    out = bd_attention(q, k, v, dropout=0.05, seed=seed)
    got = torch.autograd.grad(out.sin().sum(), (q, k, v))
    assert (bd_attention_fwd.launches, bd_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(
        bd_attention_reference(q, k, v, dropout=0.05, seed=seed).sin().sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)


def test_backward_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 8, 8, 2, 16, torch.float32, cuda)
    o, lse = _reference_forward(q, k, v, causal=False, scale=0.25, dropout=0.0, seed=None,
                                with_lse=True)
    o = o.contiguous()
    kwargs = dict(causal=False, scale=0.25, dropout=0.0)
    with pytest.raises(TypeError):
        bd_attention_bwd(*(t.double() for t in (q, k, v, o, o)), lse, **kwargs)
    with pytest.raises(ValueError, match="contiguous"):
        bd_attention_bwd(q, k, v, o, o.transpose(1, 2).contiguous().transpose(1, 2), lse,
                         **kwargs)
    with pytest.raises(ValueError, match="lse"):
        bd_attention_bwd(q, k, v, o, o, lse.double(), **kwargs)
    with pytest.raises(ValueError, match="seed"):
        bd_attention_bwd(q, k, v, o, o, lse, _seed("cpu"), causal=False, scale=0.25,
                         dropout=0.1)
    assert all(np.isfinite(g.cpu().numpy()).all()
               for g in bd_attention_bwd(q, k, v, o, o, lse, **kwargs))


# (b, l_q, l_k, h, e, d, causal): the xl model's shape classes (B cut to 8),
# then D != E, a long non-square causal shape (top-left mask), E below a
# multiple of 4, and a single key.
MHA_SHAPES = [
    (8, 256, 256, 8, 128, 128, False),
    (8, 32, 32, 8, 128, 128, False),
    (8, 15, 15, 8, 128, 128, True),
    (8, 15, 64, 8, 128, 128, False),
    (2, 100, 333, 2, 64, 32, True),
    (1, 512, 1024, 2, 64, 64, True),
    (3, 70, 70, 2, 22, 22, False),
    (2, 9, 1, 3, 128, 96, True),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,d,causal", MHA_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, d, causal, dtype):
    q, k, _ = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=6)
    v = torch.randn(b, l_k, h, d, generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda).to(dtype)
    before = mha_attention_fwd.launches
    got = mha_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert mha_attention_fwd.launches == before + 1
    assert got.shape == (b, l_q, h, d)
    _assert_close(got, mha_attention_reference(q.float(), k.float(), v.float(), causal=causal),
                  dtype)


# The tensor-core kernel's tiling edges: l_q not a multiple of 16 (17, 65),
# l_k not a multiple of the key tile (33, 65), E = 8 and 20 (20: plain loads,
# not 16-byte cp.async, in bf16), D != E, a causal shape with l_q > l_k, and
# the short shapes (one warp per (b, h)) at B*H not a multiple of 4.
MHA_EDGE_SHAPES = [
    (2, 17, 33, 3, 8, 8, False),
    (2, 65, 65, 2, 20, 20, True),
    (1, 65, 33, 3, 128, 64, True),
    (2, 17, 17, 2, 20, 8, True),
    (3, 15, 15, 3, 128, 128, True),
    (5, 15, 65, 1, 64, 64, False),
    (1, 30, 65, 3, 128, 128, False),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,d,causal", MHA_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_kernel_tiling_edges(cuda, b, l_q, l_k, h, e, d, causal, dtype):
    test_mha_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, d, causal, dtype)


# The wgmma route (bf16 and f16, Lq > 32, E and D 64 or 128): the xl encoder's L 256,
# 128 and 64 (B cut to 8), E 64, and ragged lengths (65, 100, 129, 333: past
# a 64-row warpgroup, a 128-row block, a 128-key tile), causal and not,
# D != E both ways.
MHA_WGMMA_SHAPES = [
    (8, 256, 256, 8, 128, 128, False),
    (8, 128, 128, 8, 128, 128, False),
    (8, 64, 64, 8, 128, 128, False),
    (8, 256, 256, 8, 64, 64, False),
    (2, 256, 256, 2, 128, 128, True),
    (2, 65, 65, 2, 128, 128, True),
    (2, 65, 129, 2, 128, 128, False),
    (2, 100, 100, 2, 128, 64, False),
    (2, 100, 333, 2, 128, 64, True),
    (2, 129, 129, 3, 64, 128, True),
    (2, 333, 333, 2, 128, 128, False),
    (2, 333, 65, 2, 64, 64, True),
]


@pytest.mark.parametrize("b,l_q,l_k,h,e,d,causal", MHA_WGMMA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mha_wgmma_route_matches_plain_version(cuda, b, l_q, l_k, h, e, d, causal, dtype):
    q, k, _ = _qkv(b, l_q, l_k, h, e, dtype, cuda, seed=8)
    v = torch.randn(b, l_k, h, d, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda).to(dtype)
    assert mha_route(q.dtype, l_q, l_k, e, d, True) == "wgmma"
    before = dict(mha_attention_fwd.launches_by_route)
    got = mha_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert mha_attention_fwd.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    assert got.shape == (b, l_q, h, d)
    _assert_close(got, mha_attention_reference(q.float(), k.float(), v.float(), causal=causal),
                  dtype)


@pytest.mark.parametrize("dtype,l_q", [(torch.float32, 128), (torch.bfloat16, 32),
                                       (torch.float16, 32)])
def test_mha_wgmma_route_failure_raises(cuda, monkeypatch, dtype, l_q):
    """A call the wgmma route does not take (f32; Lq <= 32), forced onto it,
    is refused by the kernel's entry, and the wrapper raises: it never
    falls back to the mma route."""
    monkeypatch.setattr(mha_module, "mha_route", lambda *args: "wgmma")
    q, k, v = _qkv(2, l_q, l_q, 2, 128, dtype, cuda)
    before = dict(mha_attention_fwd.launches_by_route)
    with pytest.raises(RuntimeError, match="wgmma route"):
        mha_attention(q, k, v)
    assert mha_attention_fwd.launches_by_route == before


def test_mha_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 8, 8, 2, 128, torch.float32, cuda)
    with pytest.raises(TypeError):
        mha_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        mha_attention(q[:, ::2], k[:, ::2].contiguous(), v[:, ::2].contiguous())
    with pytest.raises(ValueError, match="device"):
        mha_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="128"):
        wide = torch.zeros(2, 8, 2, 136, device=cuda)
        mha_attention(wide, wide, wide)
    with pytest.raises(RuntimeError, match="forward only"):
        mha_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert np.isfinite(mha_attention(q, k, v).cpu().numpy()).all()


# --- quantization kernels ------------------------------------------------------

from channelestimationtransformer_torch.ops.cuda.quant import (  # noqa: E402
    MAX_GROUP,
    fixed_point_quantize_grouped_reference,
    fixed_point_quantize_reference,
    fused_fixed_point_quantize,
    fused_fixed_point_quantize_grouped,
    fused_lsq_codeword,
    fused_nearest_codeword,
    lsq_codeword_reference,
    nearest_codeword_reference,
)
from channelestimationtransformer_torch.ops.quant.codebooks import (  # noqa: E402
    fibbinary_codebook,
    fibonacci_sequence_codebook,
    lsq_fibbinary_codebook,
)

# Element counts: the PTQ path's 128 x 128 and 128 x 64, a tail that is no
# multiple of 4, a single element, and 2^20.
QUANT_SIZES = [128 * 128, 128 * 64, 1_000_003, 1, 1 << 20]
# (wl, fl, symmetric, clamp)
QUANT_FORMATS = [(8, 4, False, True), (4, 0, True, True), (15, 11, False, False),
                 (2, -2, True, True), (5, 7, False, True)]


def _quant_input(n, scale, device, seed=0):
    """Normal values times ``scale`` with exact midpoints of the 2^-4 grid
    and +-0 written in."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, generator=g, device=device) * scale
    x[: n // 8] = (torch.floor(x[: n // 8] * 16) + 0.5) / 16
    x[:2] = torch.tensor([0.0, -0.0], device=device)[: min(n, 2)]
    return x


@pytest.mark.parametrize("n", QUANT_SIZES)
@pytest.mark.parametrize("wl,fl,symmetric,clamp", QUANT_FORMATS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_fixed_point_kernel_matches_plain_version(cuda, n, wl, fl, symmetric, clamp,
                                                  stochastic):
    x = _quant_input(n, 2.0 ** (wl - fl - 1), cuda)
    seed = _seed(cuda, 4242 + n) if stochastic else None
    kw = dict(clamp=clamp, symmetric=symmetric, stochastic=stochastic, seed=seed)
    before = fused_fixed_point_quantize.launches
    got = fused_fixed_point_quantize(x, wl, fl, **kw)
    torch.cuda.synchronize()
    assert fused_fixed_point_quantize.launches == before + 1
    want = fixed_point_quantize_reference(x, wl, fl, **kw)
    assert torch.equal(got, want)
    # Unaligned (scalar) accesses: the same tensor from its second element.
    if n > 1:
        assert torch.equal(fused_fixed_point_quantize(x[1:], wl, fl, **kw),
                           fixed_point_quantize_reference(x[1:], wl, fl, **kw))


def _flagship_group(device, seed=0):
    """The flagship's 72 PTQ tensors (52 of 128 x 128, 20 of 128 x 64),
    then ragged sizes, an empty tensor, and views that start 1 and 2
    elements into their storage (no 16-byte alignment)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = [(128, 128)] * 52 + [(128, 64)] * 20 + [(1,), (3,), (5,), (1_000_003,), (0, 4)]
    tensors = [torch.randn(s, generator=g, device=device) * 8 for s in shapes]
    base = _quant_input(4099, 8.0, device, seed=seed)
    return tensors + [base[1:], base[2:1001]]


def _bits(t):
    return t.contiguous().view(torch.int32)  # NaN compares by its bits


@pytest.mark.parametrize("wl,fl,symmetric,clamp", QUANT_FORMATS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_grouped_fixed_point_kernel_matches_plain_version(cuda, wl, fl, symmetric, clamp,
                                                          stochastic):
    """One launch over the flagship's 72 tensors, ragged sizes, an empty
    tensor and unaligned views, bit for bit with the grouped plain version
    (tensor t on Philox stream t); exact midpoints, +-0, NaN and values past
    the range written into the first tensor."""
    tensors = _flagship_group(cuda, seed=wl)
    special = torch.tensor([0.0, -0.0, float("nan"), 1e30, -1e30, 2.0 ** (wl - fl) * 3],
                           device=cuda)
    tensors[0].view(-1)[:6] = special
    tensors[1].view(-1)[: 4096] = (torch.arange(4096, device=cuda) - 2048 + 0.5) * 2.0 ** -fl
    seed = _seed(cuda, 77 + wl) if stochastic else None
    kw = dict(clamp=clamp, symmetric=symmetric, stochastic=stochastic, seed=seed)
    before = fused_fixed_point_quantize.launches
    got = fused_fixed_point_quantize_grouped(tensors, wl, fl, **kw)
    torch.cuda.synchronize()
    assert fused_fixed_point_quantize.launches == before + 1
    want = fixed_point_quantize_grouped_reference(tensors, wl, fl, **kw)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == tensors[t].shape and torch.equal(_bits(a), _bits(b)), t
    if stochastic:  # stream 0 is the single-tensor launch's
        assert torch.equal(_bits(got[0]), _bits(fused_fixed_point_quantize(tensors[0], wl, fl,
                                                                            **kw)))


def test_grouped_fixed_point_kernel_past_max_group(cuda):
    """More tensors than one launch's table: a launch per MAX_GROUP tensors,
    none for a chunk of empty tensors, and each tensor on its global stream."""
    g = torch.Generator(device=cuda).manual_seed(5)
    sizes = [0] * MAX_GROUP + [int(n) for n in torch.randint(1, 700, (2 * MAX_GROUP + 17,),
                                                             generator=g, device=cuda)]
    tensors = [torch.randn(n, generator=g, device=cuda) * 4 for n in sizes]
    seed = _seed(cuda, 9)
    before = fused_fixed_point_quantize.launches
    got = fused_fixed_point_quantize_grouped(tensors, 8, 4, stochastic=True, seed=seed)
    torch.cuda.synchronize()
    assert fused_fixed_point_quantize.launches == before + 3
    want = fixed_point_quantize_grouped_reference(tensors, 8, 4, stochastic=True, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[-1], fixed_point_quantize_reference(
        tensors[-1], 8, 4, stochastic=True, seed=seed))  # stream 400, not 0


def test_grouped_fixed_point_kernel_raises_instead_of_falling_back(cuda):
    x = torch.randn(64, device=cuda)
    with pytest.raises(TypeError):
        fused_fixed_point_quantize_grouped([x, x.double()], 8, 4)
    with pytest.raises(ValueError, match="one device"):
        fused_fixed_point_quantize_grouped([x, x.cpu()], 8, 4)
    with pytest.raises(ValueError, match="one device"):
        fused_fixed_point_quantize_grouped([x.cpu(), x], 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_fixed_point_quantize_grouped([x, x.view(8, 8).t()], 8, 4)
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize_grouped([x, x], 8, 4, stochastic=True)
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize_grouped([x, x], 8, 4, stochastic=True, seed=_seed("cpu"))
    assert all(torch.isfinite(q).all() for q in fused_fixed_point_quantize_grouped([x, x], 8, 4))


def _codebook_cases():
    g = np.random.default_rng(3)
    return [lsq_fibbinary_codebook(n) for n in (4, 8, 11)] + [
        fibbinary_codebook(8, 4), fibonacci_sequence_codebook(8, 4),
        g.permutation(lsq_fibbinary_codebook(7))]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("n", [128 * 128, 128 * 64, 1_000_003, 3])
def test_codeword_kernel_matches_plain_version(cuda, case, n):
    cb_np = _codebook_cases()[case]
    cb = torch.tensor(cb_np, dtype=torch.float32, device=cuda)
    s = np.unique(cb_np)
    x = _quant_input(n, float(s[-1] - s[0]) * 0.6, cuda, seed=case)
    mids = torch.tensor((s[1:] + s[:-1]) / 2, dtype=torch.float32, device=cuda)
    k = min(n, mids.numel())
    x[-k:] = mids[:k]  # exact ties
    before = fused_nearest_codeword.launches
    got = fused_nearest_codeword(x, cb)
    torch.cuda.synchronize()
    assert fused_nearest_codeword.launches == before + 1
    assert torch.equal(got, nearest_codeword_reference(x, cb))
    if n > 1:
        assert torch.equal(fused_nearest_codeword(x[1:], cb), nearest_codeword_reference(x[1:], cb))


def test_quant_kernels_raise_instead_of_falling_back(cuda):
    x = torch.randn(64, device=cuda)
    cb = torch.tensor(lsq_fibbinary_codebook(5), dtype=torch.float32, device=cuda)
    for bad in (x.double(), x.bfloat16()):
        with pytest.raises(TypeError):
            fused_fixed_point_quantize(bad, 8, 4)
        with pytest.raises(TypeError):
            fused_nearest_codeword(bad, cb)
    with pytest.raises(ValueError, match="contiguous"):
        fused_fixed_point_quantize(x.view(8, 8).t(), 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_nearest_codeword(x.view(8, 8).t(), cb)
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize(x, 8, 4, stochastic=True)
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize(x, 8, 4, stochastic=True, seed=_seed("cpu"))
    with pytest.raises(TypeError):
        fused_nearest_codeword(x, cb.double())
    with pytest.raises(ValueError, match="codebook"):
        fused_nearest_codeword(x, cb.cpu())
    assert torch.isfinite(fused_nearest_codeword(x, cb)).all()


def _lsq_weights(shape, nbits, step, device, seed):
    """Normal weights over 1.2x the code range, some past Qn and Qp after
    the division, with every codeword, every tie between two neighbours,
    +-0, NaN and +-1e3 (exact multiples of ``step``, a power of two for
    which grad_scale's value is the step itself)."""
    qp = 2 ** (nbits - 1) - 1
    g = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn(shape, generator=g, device=device) * qp * step * 0.6).reshape(-1)
    cb = np.asarray(lsq_fibbinary_codebook(nbits))
    special = np.concatenate([cb, (cb[1:] + cb[:-1]) / 2]) * step
    special = np.concatenate([special, [0.0, -0.0, np.nan, 1e3, -1e3]])
    k = min(w.numel(), special.size)
    w[:k] = torch.tensor(special[:k], dtype=torch.float32, device=device)
    return w.view(shape)


@pytest.mark.parametrize("nbits", [4, 8, 11])
@pytest.mark.parametrize("shape", [(128, 128), (64, 128), (128, 64), (3, 5)])
def test_lsq_mode_matches_the_eager_chain_bit_for_bit(cuda, nbits, shape):
    """The codeword kernel's LSQ mode against its plain version (the eager
    chain, snap included, on the card), compared as bits; lsq_quantize
    routes to it with use_pallas and gives the eager chain's gradients, its
    backward snapping through the kernel too."""
    from channelestimationtransformer_torch.ops.quant import lsq as tlsq

    step_value = 2.0 ** -5
    w = _lsq_weights(shape, nbits, step_value, cuda, seed=nbits)
    step = torch.tensor(step_value, device=cuda)
    cb = torch.tensor(lsq_fibbinary_codebook(nbits), dtype=torch.float32, device=cuda)
    qn, qp, g = tlsq._lsq_bounds(w, nbits)
    before = fused_nearest_codeword.launches
    got = fused_lsq_codeword(w, step, cb, g, qn, qp)
    torch.cuda.synchronize()
    assert fused_nearest_codeword.launches == before + 1
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731  NaN compares by its bits
    assert torch.equal(bits(got), bits(lsq_codeword_reference(w, step, cb, g, qn, qp)))
    # Another step size, off the power of two; and an unaligned weight.
    odd = step * 1.37
    assert torch.equal(bits(fused_lsq_codeword(w, odd, cb, g, qn, qp)),
                       bits(lsq_codeword_reference(w, odd, cb, g, qn, qp)))
    if w.numel() > 1:
        tail = w.reshape(-1)[1:]
        assert torch.equal(bits(fused_lsq_codeword(tail, odd, cb, g, qn, qp)),
                           bits(lsq_codeword_reference(tail, odd, cb, g, qn, qp)))

    r = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    finite = torch.nan_to_num(w, nan=0.5)
    results = []
    for use_pallas in (True, False):
        wt, st = finite.clone().requires_grad_(), odd.clone().requires_grad_()
        before = fused_nearest_codeword.launches
        out = tlsq.lsq_quantize(wt, st, nbits, cb, use_pallas=use_pallas)
        torch.cuda.synchronize()
        assert fused_nearest_codeword.launches == before + (1 if use_pallas else 0)
        (out * r).sum().backward()
        # The backward's snap takes the kernel as well: no plain version on card tensors.
        assert fused_nearest_codeword.launches == before + (2 if use_pallas else 0)
        results.append((out.detach(), wt.grad, st.grad))
    for a, b in zip(*results):
        assert torch.equal(bits(a), bits(b))


def test_lsq_mode_raises_instead_of_falling_back(cuda):
    w = torch.randn(16, 8, device=cuda)
    step = torch.tensor(0.05, device=cuda)
    cb = torch.tensor(lsq_fibbinary_codebook(5), dtype=torch.float32, device=cuda)
    args = (0.01, -16.0, 15.0)
    with pytest.raises(TypeError):
        fused_lsq_codeword(w.double(), step, cb, *args)
    with pytest.raises(ValueError, match="contiguous"):
        fused_lsq_codeword(w.t(), step, cb, *args)
    with pytest.raises(ValueError, match="step"):
        fused_lsq_codeword(w, step.cpu(), cb, *args)
    with pytest.raises(ValueError, match="step"):
        fused_lsq_codeword(w, step.double(), cb, *args)
    with pytest.raises(ValueError, match="codebook"):
        fused_lsq_codeword(w, step, cb.cpu(), *args)
    with pytest.raises(TypeError):
        fused_lsq_codeword(w, step, cb.double(), *args)
    assert torch.isfinite(fused_lsq_codeword(w, step, cb, *args)).all()


def test_lsq_fibbinary_model_through_the_kernel_matches_the_plain_path(cuda):
    """A small LSQ-fibbinary model on the card: one forward launches the
    codeword kernel once per quantized layer and agrees with the same
    weights through the plain versions (use_pallas=False)."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models import build_informer_lsq

    cfg = InformerConfig(d_model=32, n_heads=4, e_layers=(2, 1), d_layers=1, use_pallas=True)
    model = build_informer_lsq(cfg, nbits=8, fibbinary=True, device=cuda, seed=3)
    plain = build_informer_lsq(InformerConfig(d_model=32, n_heads=4, e_layers=(2, 1),
                                              d_layers=1), nbits=8, fibbinary=True,
                               device=cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(0)
    x_enc = torch.randn(8, 90, 16, generator=g, device=cuda)
    x_dec = torch.randn(8, 15, 16, generator=g, device=cuda)
    before = fused_nearest_codeword.launches
    with torch.no_grad():
        got = model(x_enc, x_dec)
        torch.cuda.synchronize()
        assert fused_nearest_codeword.launches == before + 28
        want = plain(x_enc, x_dec)
    assert fused_nearest_codeword.launches == before + 28  # the plain path launches none
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_ptq_weight_transform_through_the_kernel(cuda):
    """apply_weight_quant on the card: one fixed-point launch per quantized
    tensor (72 at the flagship), the tensors equal to the plain version's
    and the FP32 weights left as they were."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.ops.cuda.bd_attention import draw_seed
    from channelestimationtransformer_torch.ops.quant import (
        apply_weight_quant,
        build_weight_quant_settings,
        fixed_point_quantize,
    )

    sd = build_informer(InformerConfig(), device=cuda).state_dict()
    fp32 = {k: v.clone() for k, v in sd.items()}
    for rounding in ("nearest", "stochastic"):
        kernel = build_weight_quant_settings(sd, lambda w, p, g: fixed_point_quantize(
            w, 8, 4, rounding=rounding, generator=g))
        plain = build_weight_quant_settings(sd, lambda w, p, g: fixed_point_quantize_reference(
            w, 8, 4, stochastic=rounding == "stochastic",
            seed=draw_seed(g, w.device) if rounding == "stochastic" else None))
        before = fused_fixed_point_quantize.launches
        got = apply_weight_quant(sd, kernel,
                                 generator=torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
        assert fused_fixed_point_quantize.launches == before + 72
        want = apply_weight_quant(sd, plain,
                                  generator=torch.Generator(device=cuda).manual_seed(1))
        assert all(torch.equal(got[k], want[k]) for k in sd)
    assert all(torch.equal(sd[k], v) for k, v in fp32.items())


def test_ptq_weight_transform_through_one_grouped_launch(cuda):
    """apply_weight_quant with one FixedPointWeightQuant: one fixed-point
    launch for the flagship's 72 tensors, equal to the grouped plain version
    with the group's one seed, and the FP32 weights left as they were."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.ops.cuda.bd_attention import draw_seed
    from channelestimationtransformer_torch.ops.quant import (
        FixedPointWeightQuant,
        apply_weight_quant,
        build_weight_quant_settings,
    )

    sd = build_informer(InformerConfig(), device=cuda).state_dict()
    fp32 = {k: v.clone() for k, v in sd.items()}
    for rounding in ("nearest", "stochastic"):
        settings = build_weight_quant_settings(sd, FixedPointWeightQuant(8, 4, rounding))
        names = sorted(settings.settings)
        before = fused_fixed_point_quantize.launches
        got = apply_weight_quant(sd, settings,
                                 generator=torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
        assert len(names) == 72 and fused_fixed_point_quantize.launches == before + 1
        gen = torch.Generator(device=cuda).manual_seed(1)
        seed = draw_seed(gen, cuda) if rounding == "stochastic" else None
        want = fixed_point_quantize_grouped_reference(
            [sd[k] for k in names], 8, 4, stochastic=seed is not None, seed=seed)
        assert all(torch.equal(got[k], w) for k, w in zip(names, want))
        assert all(got[k] is sd[k] for k in sd if k not in settings)
    assert all(torch.equal(sd[k], v) for k, v in fp32.items())


# --- bf16 models through the attention kernels --------------------------------
# The kernels compute attention in f32 and round their output to bf16 once;
# the plain path (use_pallas=False) runs its einsums and softmax in bf16, as
# the JAX package's XLA path does. So a bf16 model's two paths differ by bf16
# rounding noise, and are compared as tests/test_torch_bf16.py compares the
# port with flax: max|kernel - plain| / max|plain| <= 5e-2 and NMSE <= 1e-3;
# gradients of a step each within 3e-1 of their own max abs (floor 5e-2 of
# the largest f32 gradient's), and the kernel path's worst error against the
# f32 model's gradients at most 1.25 x the plain path's.

BF16_MODEL_TOL = (5e-2, 1e-3)


def _rel_nmse(got, want):
    got, want = got.float(), want.float()
    diff = got - want
    return ((diff.abs().max() / want.abs().max()).item(),
            (diff.square().sum() / want.square().sum()).item())


def _bf16_models(cfg, device):
    """The bf16 model of ``cfg`` (kernel path), its plain path and its f32
    twin, all with the weights of seed 0."""
    import dataclasses

    from channelestimationtransformer_torch.models.informer import build_informer

    return tuple(build_informer(dataclasses.replace(cfg, **kw), device=device, seed=0)
                 for kw in ({}, dict(use_pallas=False), dict(dtype="float32")))


def test_bf16_flagship_forward_through_the_kernels_matches_the_plain_path(cuda):
    """bench.py's config, InformerConfig(use_pallas=True, dtype="bfloat16"),
    eval: 13 bd forward launches a batch, a bf16 prediction within the bf16
    limits of the plain path's."""
    from channelestimationtransformer_torch.core.config import InformerConfig

    model, plain, _ = _bf16_models(InformerConfig(use_pallas=True, dtype="bfloat16"), cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x_enc = torch.randn(64, 90, 16, generator=g, device=cuda)
    x_dec = torch.randn(64, 15, 16, generator=g, device=cuda)
    before = bd_attention_fwd.launches
    with torch.no_grad():
        got = model(x_enc, x_dec)
        torch.cuda.synchronize()
        assert bd_attention_fwd.launches == before + 13
        want = plain(x_enc, x_dec)
    assert bd_attention_fwd.launches == before + 13
    assert got.dtype == want.dtype == torch.bfloat16 and torch.isfinite(got).all()
    rel, nmse_ = _rel_nmse(got, want)
    assert rel <= BF16_MODEL_TOL[0] and nmse_ <= BF16_MODEL_TOL[1], (rel, nmse_)


def test_bf16_training_step_through_the_kernels_matches_the_plain_path(cuda):
    """One bf16 training step of the flagship (dropout 0.05, batch 64) through
    the bd forward and backward kernels against the plain path on the same
    generator seed, and both against the f32 twin's gradients; the gradients
    and parameters stay f32."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.core.metrics import nmse

    models = _bf16_models(InformerConfig(use_pallas=True, dtype="bfloat16"), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x_enc = torch.randn(64, 90, 16, generator=g, device=cuda)
    x_dec = torch.randn(64, 15, 16, generator=g, device=cuda)
    target = torch.randn(64, 5, 16, generator=g, device=cuda)
    outs, grads = [], []
    before = (bd_attention_fwd.launches, bd_attention_bwd.launches)
    for m in models:
        m.train()
        pred = m(x_enc, x_dec, generator=torch.Generator(device=cuda).manual_seed(2))
        nmse(pred, target).backward()
        outs.append(pred.detach())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    torch.cuda.synchronize()
    # The kernel path and the f32 twin launch 13 each way; the plain path none.
    assert (bd_attention_fwd.launches, bd_attention_bwd.launches) == (before[0] + 26,
                                                                     before[1] + 26)
    assert outs[0].dtype == torch.bfloat16 and outs[2].dtype == torch.float32
    rel, nmse_ = _rel_nmse(outs[0], outs[1])
    assert rel <= BF16_MODEL_TOL[0] and nmse_ <= BF16_MODEL_TOL[1], (rel, nmse_)
    assert all(gr.dtype == torch.float32 for gs in grads for gr in gs.values())
    floor = 5e-2 * max(gr.abs().max().item() for gr in grads[2].values())

    def worst(got, want):
        return max((got[n] - want[n]).abs().max().item() / max(want[n].abs().max().item(), floor)
                   for n in want)
    assert worst(grads[0], grads[1]) <= 3e-1
    assert worst(grads[0], grads[2]) <= 1.25 * worst(grads[1], grads[2])


def test_bf16_xl_forward_through_mha_matches_the_plain_path(cuda):
    """The xl width in bf16 (d_model 1024, d_ff 4096, E 128, seq_len 256;
    depth cut to e_layers (2, 1), d_layers 1), eval: its 5 attention calls
    through the mha kernel and none through bd, within the bf16 limits of the
    plain path."""
    from channelestimationtransformer_torch.core.config import InformerConfig

    cfg = InformerConfig(d_model=1024, d_ff=4096, seq_len=256, e_layers=(2, 1), d_layers=1,
                         use_pallas=True, dtype="bfloat16")
    model, plain, _ = _bf16_models(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x_enc = torch.randn(8, 256, 16, generator=g, device=cuda)
    x_dec = torch.randn(8, 15, 16, generator=g, device=cuda)
    before = (mha_attention_fwd.launches, bd_attention_fwd.launches)
    with torch.no_grad():
        got = model(x_enc, x_dec)
        torch.cuda.synchronize()
        want = plain(x_enc, x_dec)
    assert (mha_attention_fwd.launches, bd_attention_fwd.launches) == (before[0] + 5, before[1])
    assert got.dtype == want.dtype == torch.bfloat16 and torch.isfinite(got).all()
    rel, nmse_ = _rel_nmse(got, want)
    assert rel <= BF16_MODEL_TOL[0] and nmse_ <= BF16_MODEL_TOL[1], (rel, nmse_)


# The circular k=3 convolution's kernels (ops/cuda/circular_conv.py): the
# flagship's seven convolutions (C_in, C_out, L) and a tensor-parallel shard.
CONV_SHAPES = [(16, 128, 90), (16, 128, 15), (128, 128, 90), (128, 128, 45), (128, 128, 23),
               (128, 128, 12), (128, 64, 45)]
# Forward and dx: float32 sums of 3 * C products in another order than the
# plain version's matmul (rtol/atol 1e-4 / 1e-5, as the attention forward).
# dW and db sum B * L rows (92,160 at the training batch) in splits and then
# across them: atol 1e-5 of the result's largest magnitude.
CONV_TOL = (1e-4, 1e-5)


def _conv_inputs(b, l, c_in, c_out, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, l, c_in, generator=g, device=device)
    w = torch.randn(c_out, c_in, 3, generator=g, device=device) / (3 * c_in) ** 0.5
    bias = torch.randn(c_out, generator=g, device=device)
    dy = torch.randn(b, l, c_out, generator=g, device=device)
    return x, w, bias, dy


def _conv_close(got, want, scaled=False):
    atol = CONV_TOL[1] * (want.abs().max().item() if scaled else 1.0)
    torch.testing.assert_close(got, want, rtol=CONV_TOL[0], atol=atol)


def _conv_counts():
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    return (cc.circular_conv1d_fwd.launches, cc.circular_conv1d_dgrad.launches,
            cc.circular_conv1d_wgrad.launches, cc.circular_conv1d_wgrad.reductions)


@pytest.mark.parametrize("c_in,c_out,l", CONV_SHAPES)
@pytest.mark.parametrize("b", [1024, 3, 1025])
def test_circular_conv_kernels_match_plain_version(cuda, b, c_in, c_out, l):
    """Forward, dx, dW and db of the kernels against the plain versions on
    the card (TF32 off), each launch counted once."""
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    x, w, bias, dy = _conv_inputs(b, l, c_in, c_out, cuda, seed=l)
    before = _conv_counts()
    y = cc.circular_conv1d_fwd(x, w, bias)
    dx = cc.circular_conv1d_dgrad(dy, w)
    dw, db = cc.circular_conv1d_wgrad(x, dy)
    torch.cuda.synchronize()
    assert _conv_counts() == tuple(n + 1 for n in before)
    _conv_close(y, cc.circular_conv1d_reference(x, w, bias))
    _conv_close(dx, cc.circular_conv1d_dgrad_reference(dy, w))
    want_dw, want_db = cc.circular_conv1d_wgrad_reference(x, dy)
    _conv_close(dw, want_dw, scaled=True)
    _conv_close(db, want_db, scaled=True)
    dw_only, none = cc.circular_conv1d_wgrad(x, dy, with_bias=False)
    assert none is None and torch.equal(dw_only, dw)


def test_circular_conv_kernels_are_deterministic(cuda):
    """Two calls on the same inputs give the same bits (no atomics)."""
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    x, w, bias, dy = _conv_inputs(1024, 90, 128, 128, cuda)
    runs = [(cc.circular_conv1d_fwd(x, w, bias), cc.circular_conv1d_dgrad(dy, w),
             *cc.circular_conv1d_wgrad(x, dy)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flagship_training_step_goes_through_the_conv_kernels(cuda):
    """One float32 training step of the flagship: 7 forward launches, 5 data
    gradients (not the embeddings', whose input is data), 7 weight-gradient
    passes and 7 reductions, and finite gradients."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.models.informer import build_informer

    model = build_informer(InformerConfig(use_pallas=True), device=cuda, seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    x_enc = torch.randn(32, 90, 16, generator=g, device=cuda)
    x_dec = torch.randn(32, 15, 16, generator=g, device=cuda)
    target = torch.randn(32, 5, 16, generator=g, device=cuda)
    model.train()
    before = _conv_counts()
    nmse(model(x_enc, x_dec, generator=torch.Generator(device=cuda).manual_seed(2)),
         target).backward()
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(_conv_counts(), before)) == (7, 5, 7, 7)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_bf16_conv_keeps_the_cudnn_route(cuda):
    """A bf16 (or f16) convolution, or one of another K, takes the circular
    pad and cuDNN's F.conv1d: the kernels' counters stay where they were."""
    from channelestimationtransformer_torch.models.embed import circular_conv1d

    x, w, bias, _ = _conv_inputs(8, 45, 128, 128, cuda)
    before = _conv_counts()
    for dtype in (torch.bfloat16, torch.float16):
        xr = x.to(dtype).requires_grad_()
        circular_conv1d(xr, w.to(dtype), bias.to(dtype)).sum().backward()
    circular_conv1d(x, torch.randn(128, 128, 5, device=cuda))
    torch.cuda.synchronize()
    assert _conv_counts() == before


def test_flop_count_of_the_flagship_on_the_card_equals_the_cpus(cuda):
    """``model_complexity`` counts matmuls and convolutions under a dispatch
    mode, which sees no ctypes launch, so it counts on a CPU copy of the
    model: the count equals the CPU's and no conv kernel runs."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.utils.complexity import model_complexity

    counts = []
    for device in ("cpu", cuda):
        model = build_informer(InformerConfig(use_pallas=True), device=device, seed=0)
        x_enc, x_dec = torch.zeros(2, 90, 16, device=device), torch.zeros(2, 15, 16, device=device)
        before = _conv_counts()
        counts.append(model_complexity(model, x_enc, x_dec)["macs_per_sample"])
        assert _conv_counts() == before
    assert counts[0] == counts[1] == 43_688_704


def test_circular_conv_launch_refused_for_shared_memory_raises(cuda, monkeypatch):
    """A launch asking for more shared memory than an SM has is refused, and
    the wrapper raises; nothing is counted."""
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    x, w, bias, dy = _conv_inputs(4, 23, 128, 128, cuda)
    monkeypatch.setattr(cc, "_smem", lambda kind, c_in: 300 * 1024)
    before = _conv_counts()
    with pytest.raises(RuntimeError, match="forward launch failed"):
        cc.circular_conv1d_fwd(x, w, bias)
    with pytest.raises(RuntimeError, match="data gradient launch failed"):
        cc.circular_conv1d_dgrad(dy, w)
    with pytest.raises(RuntimeError, match="launch failed"):
        cc.circular_conv1d_wgrad(x, dy)
    assert _conv_counts() == before


def test_circular_conv_kernels_raise_instead_of_falling_back(cuda):
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    x, w, bias, dy = _conv_inputs(4, 23, 16, 32, cuda)
    with pytest.raises(TypeError):
        cc.circular_conv1d_fwd(x.double(), w.double())
    with pytest.raises(TypeError):
        cc.circular_conv1d_wgrad(x.bfloat16(), dy.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        cc.circular_conv1d_fwd(x.transpose(0, 1), w)
    with pytest.raises(ValueError, match="contiguous"):
        cc.circular_conv1d_dgrad(dy[:, ::2], w)
    with pytest.raises(ValueError, match="device"):
        cc.circular_conv1d_fwd(x, w.cpu())
    with pytest.raises(ValueError, match="channels"):
        cc.circular_conv1d_dgrad(x, w)
    with pytest.raises(ValueError, match="bias"):
        cc.circular_conv1d_fwd(x, w, bias[:8])
    assert torch.isfinite(cc.circular_conv1d_fwd(x, w, bias)).all()
