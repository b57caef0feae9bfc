"""The CUDA kernels (bd-attention forward, with and without dropout, and
backward; the mha-attention forward; fixed-point quantization and the
nearest-codeword snap, plain and in its LSQ mode) against their plain
versions, on the card.

Marked ``cuda``; each test skips when no card is present. This file imports
only torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: forward float32 rtol 1e-4 / atol 1e-5 (the kernel sums in
another order than the plain version's matmuls, both in f32); backward
float32 rtol 2e-4 / atol 2e-5 (longer sums: dK and dV run over up to 512
query rows); bfloat16 is checked in its own dtype against the plain version
on the same bf16 inputs, rtol/atol 1e-2 (one bf16 rounding of the result,
2^-8 relative). The dropout mask is compared exactly: both run the same
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
from channelestimationtransformer_torch.ops.cuda.mha_attention import (
    mha_attention,
    mha_attention_fwd,
    mha_attention_reference,
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
DTYPES = [torch.float32, torch.bfloat16]


def _seed(device, value=0x1234_5678_9ABC):
    return torch.tensor([value], dtype=torch.int64, device=device)


def _assert_close(got, want, dtype, tol=(1e-4, 1e-5)):
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
    else:
        torch.testing.assert_close(got, want.to(dtype), rtol=1e-2, atol=1e-2)


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
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(got, want.to(dtype), rtol=1e-2, atol=1e-2)


def test_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 8, 8, 2, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        bd_attention(q.half(), k.half(), v.half())
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
def test_kernel_dropout_mask_is_the_plain_mask(cuda, b, l_q, l_k, h, e, causal):
    """The kernel's mask read back through one-hot values: with V's row j
    the unit vector of column j - e*g, output column c of pass g is
    P_drop[:, e*g + c], nonzero exactly where the key is kept."""
    q, k, _ = _qkv(b, l_q, l_k, h, e, torch.float32, cuda, seed=2)
    seed = _seed(cuda, 987654321)
    kept = torch.zeros(b, h, l_q, l_k, dtype=torch.bool, device=cuda)
    for g in range(0, l_k, e):
        v = torch.zeros(b, l_k, h, e, device=cuda)
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
        _assert_close(g, w, dtype, tol=(2e-4, 2e-5))


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


def test_backward_kernel_is_deterministic(cuda):
    """Each gradient element is summed by one warp in a fixed order (no
    atomics): two calls on the same inputs give the same bits."""
    q, k, v = _qkv(64, 90, 90, 8, 16, torch.float32, cuda, seed=8)
    seed = _seed(cuda)
    kw = dict(causal=False, scale=0.25, dropout=0.05)
    o, lse = _reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
    o = o.contiguous()
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda)
    first = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    second = bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
        bd_attention_bwd(*(t.half() for t in (q, k, v, o, o)), lse, **kwargs)
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


def test_mha_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(2, 8, 8, 2, 128, torch.float32, cuda)
    with pytest.raises(TypeError):
        mha_attention(q.half(), k.half(), v.half())
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
