"""The CUDA attention kernel against its plain version, on the card.

Marked ``cuda``; each test skips when no card is present. This file imports
only torch and numpy, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-4 / atol 1e-5 (the kernel sums in another order
than the plain version's matmuls, both in f32); bfloat16 is checked in its
own dtype against the plain version on the upcast inputs, rtol/atol 1e-2
(one bf16 rounding of the output, 2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.ops.cuda.bd_attention import (
    bd_attention,
    bd_attention_reference,
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


@pytest.mark.parametrize("b,l_q,l_k,h,e,causal", [
    (256, 90, 90, 8, 16, False),
    (256, 15, 15, 8, 16, True),
    (256, 15, 24, 8, 16, False),
    (4, 45, 45, 4, 32, False),    # d_model sweep: E = 32
    (2, 128, 128, 2, 64, True),   # largest E: dynamic shared memory > 48 KB
    (2, 512, 100, 2, 24, False),  # long query tiled over the warps; E not a power of two
    (3, 1, 1, 1, 1, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, b, l_q, l_k, h, e, causal, dtype):
    q, k, v = _qkv(b, l_q, l_k, h, e, dtype, cuda)
    before = bd_attention.launches
    got = bd_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert bd_attention.launches == before + 1
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
