"""The mha kernel's wgmma route on the CPU: the routing rule
(``mha_route``) pinned at every call of the ``xl``, ``large`` and
``MHA_EXTRA_SHAPES`` shapes, and a torch emulation of the route's
arithmetic held against the plain version and, at one shape, against the
JAX package's ``_attn_kernel_blhe`` through ``pl.pallas_call(...,
interpret=True)``. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The emulation follows ``csrc/mha_attention_fwd.cu``'s wgmma route: keys in
tiles of BK (128 where Lq > 64, else 64), S = Q K^T as exact bf16 products
summed in f32, the online softmax in log2 units tile by tile (the row's
running maximum, the rescale of the running sum and of O), P rounded to
bf16 once for P V (O summed in f32), then O / l rounded to bf16.
Tolerance: rtol / atol 1e-2 against the plain version rounded to bf16, as
the card's check (one bf16 rounding of P and of the result, 2^-8 relative).
"""

import functools
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from channelestimationtransformer_tpu.ops.pallas.attention import _attn_kernel_blhe

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.ops.cuda.mha_attention import (
    ROUTES,
    aligned16,
    mha_attention,
    mha_attention_fwd,
    mha_attention_reference,
    mha_route,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (l_q, l_k, e, d) -> the bf16 route; every f32 call takes "mma". The xl
# model's six call classes (B 64, H 8, E 128), the int8 A/B's `large` call
# (E 64), MHA_EXTRA_SHAPES, and widths the wgmma route does not take.
ROUTED = [
    ((256, 256, 128, 128), "wgmma"),
    ((128, 128, 128, 128), "wgmma"),
    ((64, 64, 128, 128), "wgmma"),
    ((32, 32, 128, 128), "mma"),
    ((15, 15, 128, 128), "mma"),
    ((15, 64, 128, 128), "mma"),
    ((256, 256, 64, 64), "wgmma"),
    ((100, 333, 128, 64), "wgmma"),
    ((512, 1024, 64, 64), "wgmma"),
    ((33, 7, 64, 64), "wgmma"),
    ((256, 256, 96, 96), "mma"),
    ((256, 256, 16, 16), "mma"),
    ((256, 256, 128, 96), "mma"),
    ((256, 256, 96, 128), "mma"),
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,bf16_route", ROUTED)
def test_route_of_each_call(shape, bf16_route, dtype):
    want = bf16_route if dtype == BF16 else "mma"
    assert mha_route(dtype, *shape, True) == want
    assert mha_route(dtype, *shape, False) == "mma"  # TMA takes 16-byte aligned tensors only


def test_route_covers_the_listed_shapes():
    """Every xl, scale-demo and MHA_EXTRA_SHAPES call of chip_smoke.py is a row of ROUTED."""
    listed = {shape for shape, _ in ROUTED}
    calls = {(l_q, l_k, chip_smoke.XL_E, chip_smoke.XL_E)
             for _, l_q, l_k, _, _ in chip_smoke.XL_SHAPES}
    calls |= {(l_q, l_k, e, d) for _, l_q, l_k, _, _, _, _, e, d in chip_smoke.MHA_EXTRA_SHAPES}
    calls |= {(l_q, l_k, e, d) for _, l_q, l_k, _, _, _, _, e, d
              in chip_smoke.scale_kernel_shapes()[1]}
    assert calls <= listed


def test_a_misaligned_view_takes_the_mma_route():
    flat = torch.zeros(2 * 64 * 2 * 128 + 8, dtype=BF16)
    q = flat[1:1 + 2 * 64 * 2 * 128].view(2, 64, 2, 128)  # 2 bytes past a 16-byte boundary
    k = torch.zeros(2, 64, 2, 128, dtype=BF16)
    assert q.is_contiguous() and not aligned16(q, k, k)
    assert mha_route(q.dtype, 64, 64, 128, 128, aligned16(q, k, k)) == "mma"
    assert mha_route(q.dtype, 64, 64, 128, 128, aligned16(k, k, k)) == "wgmma"


@pytest.mark.parametrize("dtype,want", [("bfloat16", {"mma": 8, "wgmma": 5}),
                                        ("float32", {"mma": 13, "wgmma": 0})])
def test_xl_batch_by_route(dtype, want):
    """The xl eval batch's 13 mha calls: in bf16 the L 256, 128 and 64
    encoder calls (1 + 2 + 2) take wgmma; L 32, the decoder's causal L 15
    and its 15 x 64 cross calls take mma."""
    cfg = InformerConfig(d_model=1024, d_ff=4096, seq_len=256, use_pallas=True)
    assert chip_smoke.mha_routes(cfg, getattr(torch, dtype)) == want
    assert chip_smoke.mha_routes(cfg, getattr(torch, dtype), 8) == {
        r: 8 * n for r, n in want.items()}
    weights = {(l_q, l_k): calls for _, l_q, l_k, _, calls in chip_smoke.XL_SHAPES}
    by_shape = dict.fromkeys(ROUTES, 0)
    for (l_q, l_k), calls in weights.items():
        by_shape[mha_route(getattr(torch, dtype), l_q, l_k, 128, 128, True)] += calls
    assert by_shape == want


def test_cpu_launches_nothing_on_either_route():
    q = torch.zeros(2, 64, 2, 128, dtype=BF16)
    before = dict(mha_attention_fwd.launches_by_route)
    assert set(before) == set(ROUTES)
    mha_attention(q, q, q)
    assert mha_attention_fwd.launches_by_route == before


def emulate_wgmma_route(q, k, v, *, causal, scale=None):
    """The wgmma route's arithmetic in torch (module docstring), from bf16
    q, k, v ``[B, L, H, E]``; output bf16 ``[B, Lq, H, D]``."""
    b, l_q, h, e = q.shape
    l_k, d = k.shape[1], v.shape[3]
    bk = 128 if l_q > 64 else 64
    scale_log2 = np.float32((scale if scale is not None else 1 / math.sqrt(e)) * LOG2E)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, L, W]
    rows = torch.arange(l_q).view(l_q, 1)
    m = torch.full((b, h, l_q, 1), -math.inf)
    l_sum = torch.zeros(b, h, l_q, 1)
    o = torch.zeros(b, h, l_q, d)
    for j0 in range(0, l_k, bk):
        keys = torch.arange(j0, min(j0 + bk, l_k)).view(1, -1)
        s = (qf @ kf[:, :, j0:j0 + bk].transpose(-1, -2)) * scale_log2  # exact products, f32 sums
        if causal:
            s = s.masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(BF16).float() @ vf[:, :, j0:j0 + bk]
        m = m_new
    return (o / l_sum).to(BF16).transpose(1, 2)


def _bf16_qkv(b, l_q, l_k, h, e, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, n, h, w)).astype(np.float32)).to(BF16)
                 for n, w in ((l_q, e), (l_k, e), (l_k, d)))


# (l_q, l_k, e, d, causal) at B 2, H 2: the xl encoder's three lengths, E 64,
# a ragged non-square causal shape with D != E, and a ragged causal one.
EMULATED = [
    (256, 256, 128, 128, False),
    (128, 128, 128, 128, False),
    (64, 64, 128, 128, False),
    (256, 256, 64, 64, False),
    (100, 333, 128, 64, True),
    (65, 129, 128, 128, True),
]


@pytest.mark.parametrize("l_q,l_k,e,d,causal", EMULATED)
def test_emulation_matches_the_plain_version(l_q, l_k, e, d, causal):
    q, k, v = _bf16_qkv(2, l_q, l_k, 2, e, d, seed=l_q + l_k + e)
    got = emulate_wgmma_route(q, k, v, causal=causal)
    want = mha_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == BF16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.to(BF16).float(), rtol=1e-2, atol=1e-2)


def test_emulation_tiles_differ_from_one_pass():
    """The tiling is real: the emulation with tiles of BK differs (by
    rounding) from one softmax over all keys, which the plain version is."""
    q, k, v = _bf16_qkv(2, 256, 256, 2, 128, 128, seed=3)
    got = emulate_wgmma_route(q, k, v, causal=False).float()
    one_pass = mha_attention(q, k, v).float()
    assert not torch.equal(got, one_pass)
    assert (got - one_pass).abs().max() < 2e-2


def _blhe_interpret(q, k, v, causal):
    """The ``[B, L, H, E]`` Pallas kernel, one grid cell per batch element,
    as ``tests/test_torch_mha_attention.py`` runs it."""
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


def test_emulation_matches_the_pallas_kernel():
    """At the xl encoder's L 128 (B 2, H 2, E 128): the emulation against
    the JAX package's kernel on the same bf16 values, given in f32."""
    q, k, v = _bf16_qkv(2, 128, 128, 2, 128, 128, seed=11)
    got = emulate_wgmma_route(q, k, v, causal=False)
    want = np.asarray(_blhe_interpret(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                      False))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_weight_only_call_dtypes_follow_the_served_model(monkeypatch):
    """chip_smoke's dtype of each attention call under weight-only int8
    serving of a bf16 model (which sets the int8 A/B's mha counts by
    route) against the dtypes the served flagship's calls see here."""
    import channelestimationtransformer_torch.models.attention as attention
    from channelestimationtransformer_torch.cli.int8_serving import _serve
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.ops.quant.serving import build_int8_table

    seen = []

    def recorder(kernel):
        def call(q, k, v, **kwargs):
            seen.append(q.dtype)
            return kernel(q, k, v, **kwargs)
        return call
    monkeypatch.setattr(attention, "bd_attention", recorder(attention.bd_attention))
    monkeypatch.setattr(attention, "mha_attention", recorder(attention.mha_attention))
    cfg = InformerConfig(dtype="bfloat16", use_pallas=True)
    model = build_informer(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x_enc = torch.as_tensor(rng.normal(size=(2, cfg.seq_len, cfg.enc_in)), dtype=F32)
    x_dec = torch.as_tensor(rng.normal(size=(2, cfg.dec_len, cfg.dec_in)), dtype=F32)
    with torch.no_grad():
        _serve(model, build_int8_table(model), "weight_only")(x_enc, x_dec)
    assert seen == chip_smoke.weight_only_call_dtypes(torch, cfg)
    assert seen.count(BF16) == len(cfg.e_layers) + 1  # each stack's first call, the first self call
