"""The circular k=3 convolution's plain versions (``ops/cuda/circular_conv.py``)
on the CPU: forward, data, weight and bias gradients against a circular
``F.pad`` and ``F.conv1d`` at the flagship's shapes and a tensor-parallel
shard's, with and without bias and input gradient; float64 ``gradcheck``
on small shapes; the ``cet.conv`` span of the gradients; and the routing
(``models/embed.py:circular_conv1d`` sends only CUDA float32 to the
module). The kernels themselves run on the card (``tests/test_torch_cuda.py``).

Tolerances: float32 rtol 1e-4 / atol 1e-5, as the kernels' own on the card:
both sides sum the same 3 * C_in products (or B * L rows for the weight
gradient, relative to its largest magnitude) in different orders.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F

from channelestimationtransformer_torch.models import embed
from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

# (C_in, C_out, L): both embeddings (C_in 16; L 90 and 15), the distil convs
# (C 128; L 90, 45, 23, 12) and a tensor-parallel shard (C_out 64 at world 2).
SHAPES = [(16, 128, 90), (16, 128, 15), (128, 128, 90), (128, 128, 45), (128, 128, 23),
          (128, 128, 12), (128, 64, 45)]
BATCH = 3
TOL = dict(rtol=1e-4, atol=1e-5)


def _pad_conv(x, w, b):
    """Today's route: circular pad and ``F.conv1d`` on ``[B, C, L]``."""
    return F.conv1d(F.pad(x.transpose(1, 2), (1, 1), mode="circular"), w, b).transpose(1, 2)


def _inputs(c_in, c_out, l, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, l, c_in, generator=g, dtype=dtype)
    w = torch.randn(c_out, c_in, 3, generator=g, dtype=dtype) / (3 * c_in) ** 0.5
    b = torch.randn(c_out, generator=g, dtype=dtype)
    dy = torch.randn(BATCH, l, c_out, generator=g, dtype=dtype)
    return x, w, b, dy


@pytest.mark.parametrize("c_in,c_out,l", SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_forward_matches_pad_conv1d(c_in, c_out, l, with_bias):
    x, w, b, _ = _inputs(c_in, c_out, l)
    b = b if with_bias else None
    want = _pad_conv(x, w, b)
    torch.testing.assert_close(cc.circular_conv1d_reference(x, w, b), want, **TOL)
    torch.testing.assert_close(cc.circular_conv1d(x, w, b), want, **TOL)


@pytest.mark.parametrize("c_in,c_out,l", SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("input_grad", [True, False])
def test_plain_gradients_match_pad_conv1d(monkeypatch, c_in, c_out, l, with_bias, input_grad):
    """dx, dW and db of the differentiable entry (its backward's plain
    versions) against autograd through pad and ``F.conv1d``; with the
    input's gradient off (an embedding's input is data) the data gradient
    does not run."""
    dgrads = []
    plain = cc.circular_conv1d_dgrad_reference
    monkeypatch.setattr(cc, "circular_conv1d_dgrad", lambda dy, w: dgrads.append(1) or plain(dy, w))
    x, w, b, dy = _inputs(c_in, c_out, l)
    x.requires_grad_(input_grad), w.requires_grad_(), b.requires_grad_()
    b = b if with_bias else None
    leaves = [t for t in (x, w, b) if t is not None and t.requires_grad]
    got = torch.autograd.grad(cc.circular_conv1d(x, w, b), leaves, dy)
    want = torch.autograd.grad(_pad_conv(x, w, b), leaves, dy)
    assert len(dgrads) == int(input_grad) and len(got) == 1 + input_grad + with_bias
    for g_, w_ in zip(got, want):  # dW and db sum B * L rows: atol by their scale
        torch.testing.assert_close(g_, w_, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, w_.abs().max().item()))


@pytest.mark.parametrize("c_in,c_out,l", SHAPES)
def test_plain_gradient_functions_match_pad_conv1d(c_in, c_out, l):
    """The plain dgrad and wgrad functions the kernels are held to on the
    card, called directly, against ``F.conv1d``'s autograd."""
    x, w, b, dy = _inputs(c_in, c_out, l)
    x.requires_grad_(), w.requires_grad_(), b.requires_grad_()
    want_dx, want_dw, want_db = torch.autograd.grad(_pad_conv(x, w, b), (x, w, b), dy)
    x, w = x.detach(), w.detach()
    torch.testing.assert_close(cc.circular_conv1d_dgrad_reference(dy, w), want_dx, **TOL)
    dw, db = cc.circular_conv1d_wgrad_reference(x, dy)
    scale = want_dw.abs().max().item()
    torch.testing.assert_close(dw, want_dw, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    torch.testing.assert_close(db, want_db, rtol=TOL["rtol"], atol=TOL["atol"] * BATCH * l)
    assert cc.circular_conv1d_wgrad_reference(x, dy, with_bias=False)[1] is None


@pytest.mark.parametrize("c_in,c_out,l", [(3, 4, 5), (2, 3, 1), (2, 2, 2), (4, 3, 7)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_version_gradcheck(c_in, c_out, l, with_bias):
    """float64 ``gradcheck`` of the differentiable entry; L 1 and 2 wrap a
    tap onto the row itself or its only neighbour."""
    x, w, b, _ = _inputs(c_in, c_out, l, dtype=torch.float64, seed=l)
    args = (x.requires_grad_(), w.requires_grad_(), b.requires_grad_() if with_bias else None)
    assert torch.autograd.gradcheck(cc.circular_conv1d, args)


def test_circular_conv1d_routes_by_what_it_sees(monkeypatch):
    """The module's entry takes its plain version for CPU tensors; the
    model's ``embed.circular_conv1d`` sends only CUDA float32 with three
    taps to the module, so every CPU call, whatever its dtype or K, keeps
    the pad and ``F.conv1d``."""
    seen = []
    monkeypatch.setattr(cc, "circular_conv1d_reference",
                        lambda *a: seen.append(a[0].dtype) or _pad_conv(*a))
    x, w, b, _ = _inputs(16, 8, 9)
    torch.testing.assert_close(cc.circular_conv1d(x, w, b), _pad_conv(x, w, b))
    assert seen == [torch.float32]
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        got = embed.circular_conv1d(x.to(dtype), w.to(dtype), b.to(dtype))
        assert got.dtype == dtype and torch.equal(got, _pad_conv(x.to(dtype), w.to(dtype),
                                                                 b.to(dtype)))
    wide = torch.randn(8, 16, 5, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(embed.circular_conv1d(x, wide), F.conv1d(
        F.pad(x.transpose(1, 2), (2, 2), mode="circular"), wide).transpose(1, 2))
    assert seen == [torch.float32]
    with pytest.raises(ValueError, match="three taps"):
        cc.circular_conv1d(x, wide)


def test_plain_version_counts_the_convolutions_flops():
    """Under ``FlopCounterMode`` (``utils/complexity.py``, on the CPU) the
    plain version counts the FLOPs of ``F.conv1d``'s convolution, so a
    count does not depend on which of the two a CPU call takes."""
    from torch.utils.flop_counter import FlopCounterMode

    x, w, b, _ = _inputs(16, 8, 9)
    with FlopCounterMode(display=False) as counter:
        cc.circular_conv1d(x, w, b)
    with FlopCounterMode(display=False) as want:
        _pad_conv(x, w, b)
    assert counter.get_total_flops() == want.get_total_flops() == 2 * BATCH * 9 * 16 * 8 * 3


@pytest.mark.parametrize("input_grad", [True, False])
def test_gradients_run_inside_a_conv_span(input_grad):
    """The entry's backward opens ``cet.conv`` around its gradients (on the
    card its kernels launch there, from autograd's thread), so the
    benchmark's conv time keeps them; one span a forward and one a
    backward."""
    from torch.profiler import ProfilerActivity, profile

    x, w, b, dy = _inputs(16, 8, 9)
    x.requires_grad_(input_grad), w.requires_grad_(), b.requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("forward"):
            y = cc.circular_conv1d(x, w, b)
        y.backward(dy)
    names = [e.name for e in prof.events() if e.name in ("cet.conv", "forward")]
    assert names == ["forward", "cet.conv"]
    assert w.grad is not None and (x.grad is not None) == input_grad


def test_kernel_wrappers_raise_instead_of_falling_back():
    """The wrappers take CPU tensors to the plain versions and raise on a
    device the kernels do not run on."""
    x, w, b, dy = _inputs(16, 8, 9)
    torch.testing.assert_close(cc.circular_conv1d_fwd(x, w, b), _pad_conv(x, w, b), **TOL)
    with pytest.raises(ValueError, match="meta"):
        cc.circular_conv1d_fwd(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        cc.circular_conv1d_dgrad(dy.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        cc.circular_conv1d_wgrad(x.to("meta"), dy.to("meta"))
