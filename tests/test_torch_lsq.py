"""The port's LSQ and LSQ-fibbinary layers and models on the CPU against
the JAX package's.

- ``lsq_quantize``: the snapped codes (``nearest(clip(w / s))`` or its
  rounding) and the quantized weight equal JAX's exactly (JAX run op by op,
  unjitted, so that each op rounds once as written); gradients with respect
  to the weight and ``step_size`` within rtol 1e-5 of ``jax.grad`` (float32;
  the step size's is a long sum with cancelling terms, taken in another
  order, so it also has an atol of 1e-7 of its terms' magnitudes). For
  nbits 4 and 8, with and without fibbinary.
- A small LSQ-fibbinary (and plain LSQ) InformerStack from flax
  ``build_informer_lsq`` through ``from_flax``: every layer's codes equal,
  and the eval forward with ``use_pallas`` on and off within rtol 2e-4 /
  atol 2e-5 of flax (float32 on the CPU, sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models.informer_lsq import (
    build_informer_lsq as jax_build_informer_lsq,
)
from channelestimationtransformer_tpu.ops.quant import codebooks as jcb
from channelestimationtransformer_tpu.ops.quant import lsq as jlsq

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models import build_informer_lsq
from channelestimationtransformer_torch.ops.quant import lsq as tlsq
from channelestimationtransformer_torch.ops.quant.codebooks import lsq_fibbinary_codebook
from channelestimationtransformer_torch.utils.convert import FlaxBridge, load_flax

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(seq_len=24, label_len=6, pred_len=5, d_model=32, n_heads=4,
             e_layers=(2, 1), d_layers=1, d_ff=32, dropout=0.0)


def _weights(shape, nbits, seed):
    """A weight and the step size of its init, times a factor so that
    some of w / s falls outside [Qn, Qp] and clamps."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) * 0.2
    qp = 2 ** (nbits - 1) - 1
    s = np.float32(np.abs(w).mean() / np.sqrt(qp) * 0.25)
    return w, s


def _jax_codes(w, s, nbits, cb):
    """JAX's snapped codes: nearest(clip(w / s_g, Qn, Qp)) (or its rounding)
    with s_g the value of grad_scale(s, g)."""
    qn, qp = -(2 ** (nbits - 1)), 2 ** (nbits - 1) - 1
    s_g = jlsq.grad_scale(jnp.asarray(s), 1.0 / np.sqrt(w.size * qp))
    scaled = jnp.clip(jnp.asarray(w) / s_g, qn, qp)
    return np.asarray(jnp.round(scaled) if cb is None else jcb.nearest_codeword(scaled, cb))


def _torch_codes(w, s, nbits, codebook):
    qn, qp = -(2 ** (nbits - 1)), 2 ** (nbits - 1) - 1
    s_g = tlsq.grad_scale(s, 1.0 / np.sqrt(w.numel() * qp))
    scaled = torch.clamp(w / s_g, qn, qp)
    return (torch.round(scaled) if codebook is None
            else tlsq.nearest_codeword(scaled, codebook)).numpy()


@pytest.mark.parametrize("nbits", [4, 8])
@pytest.mark.parametrize("fibbinary", [False, True])
@pytest.mark.parametrize("shape", [(32, 48), (128, 128)])
def test_lsq_quantize_values_and_gradients_match_jax(nbits, fibbinary, shape):
    w, s = _weights(shape, nbits, seed=nbits + 10 * fibbinary)
    cb = jcb.lsq_fibbinary_codebook(nbits) if fibbinary else None
    tcb = torch.tensor(lsq_fibbinary_codebook(nbits), dtype=torch.float32) if fibbinary else None
    r = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    wt = torch.tensor(w, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    codes = _torch_codes(wt.detach(), st.detach(), nbits, tcb)
    np.testing.assert_array_equal(codes, _jax_codes(w, s, nbits, cb))
    assert (np.abs(w / s) > 2 ** (nbits - 1)).any()  # some values clamp

    got = tlsq.lsq_quantize(wt, st, nbits, tcb)
    want = jlsq.lsq_quantize(jnp.asarray(w), jnp.asarray(s), nbits, cb)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))

    (got * torch.from_numpy(r)).sum().backward()
    gw, gs = jax.grad(lambda w_, s_: jnp.sum(jlsq.lsq_quantize(w_, s_, nbits, cb) * r),
                      argnums=(0, 1))(jnp.asarray(w), jnp.asarray(s))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-7)
    # d/ds is a sum over every element with cancelling signs, taken in
    # another order by XLA: beside rtol 1e-5, allow 1e-7 of the sum of the
    # terms' magnitudes, g * |r| * (|code| + |w / s|) (a few float32 ulps of it).
    qp = 2 ** (nbits - 1) - 1
    g = 1.0 / np.sqrt(w.size * qp)
    terms = g * np.sum(np.abs(r) * (np.abs(codes) + np.minimum(np.abs(w / s), qp + 1)))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), rtol=1e-5, atol=1e-7 * terms)


def test_ste_helpers_values_and_gradients():
    x = torch.tensor([0.3, 1.5, 2.5, -2.5, 3.7], requires_grad=True)
    v = tlsq.round_pass(x)
    assert torch.equal(v.detach(), (torch.round(x) - x).detach() + x.detach())
    assert v.detach().tolist() == [0.0, 2.0, 2.0, -2.0, 4.0]  # half to even
    v.sum().backward()
    assert x.grad.tolist() == [1.0] * 5
    s = torch.tensor(0.7, requires_grad=True)
    tlsq.grad_scale(s, 0.25).backward()
    assert s.grad.item() == 0.25
    cb = torch.tensor([-2.0, 0.0, 1.0, 4.0])
    y = torch.tensor([0.5, 2.5, -7.0, 9.0], requires_grad=True)
    for use_pallas in (True, False):
        out = tlsq.codebook_pass(y, cb, use_pallas=use_pallas)
        assert out.detach().tolist() == [0.0, 1.0, -2.0, 4.0]  # ties to the lower index
        (g,) = torch.autograd.grad(out.sum(), y)
        assert g.tolist() == [1.0] * 4


@pytest.mark.parametrize("fibbinary", [False, True])
def test_dense_lsq_layer_matches_flax(fibbinary):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    fmod = jlsq.DenseLSQ(40, nbits=8, quantize=True, fibbinary=fibbinary)
    params = jax.jit(fmod.init)(jax.random.key(1), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    params["bias"] = rng.normal(size=40).astype(np.float32) * 0.1
    bridge = FlaxBridge(params)
    bridge.dense("")
    bridge.check_consumed()
    tmod = tlsq.DenseLSQ(24, 40, nbits=8, fibbinary=fibbinary)
    tmod.load_state_dict(bridge.state_dict, strict=True)
    assert tmod.step_size.shape == () and "codebook" not in tmod.state_dict()
    # The step size of the init is the same function of the weight.
    np.testing.assert_allclose(
        tlsq.lsq_step_size_init(tmod.weight, 8).item(), params["step_size"], rtol=1e-6)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(fmod.apply)({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _lsq_pair(rng, fibbinary, nbits=8):
    """Flax params of the small LSQ InformerStack, perturbed (kernels and
    biases by noise, each step size by a factor in [0.8, 1.2]), and the port
    model loaded from them."""
    jcfg = JaxInformerConfig(**SMALL)
    fmod = jax_build_informer_lsq(jcfg, nbits=nbits, fibbinary=fibbinary)
    x_enc = rng.normal(size=(3, jcfg.seq_len, 16)).astype(np.float32)
    x_dec = rng.normal(size=(3, jcfg.dec_len, 16)).astype(np.float32)
    v = jax.jit(fmod.init)(jax.random.key(0), jnp.asarray(x_enc), jnp.asarray(x_dec))

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "step_size":
            return (a * rng.uniform(0.8, 1.2)).astype(np.float32)
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    return jcfg, fmod, params, stats, x_enc, x_dec


def _lsq_layers(tree, path=()):
    """(path, kernel, step_size) of every LSQ layer of a flax params tree."""
    if "step_size" in tree:
        yield ".".join(path), tree["kernel"], tree["step_size"]
        return
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _lsq_layers(sub, path + (name,))


@pytest.mark.parametrize("fibbinary", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_small_lsq_informer_stack_matches_flax(fibbinary, use_pallas):
    """InformerConfig(lsq_nbits=8, lsq_fibbinary=...) at a small width,
    weights from flax: the same codes in every layer and the same eval
    forward. With use_pallas both sides take their attention kernels
    (Pallas in interpret mode; the port's plain versions on the CPU) and the
    port's fibbinary snap takes the kernel wrapper."""
    rng = np.random.default_rng(5)
    jcfg, fmod, params, stats, x_enc, x_dec = _lsq_pair(rng, fibbinary)
    cfg = InformerConfig(use_pallas=use_pallas, **SMALL)
    model = build_informer_lsq(cfg, nbits=8, fibbinary=fibbinary, device="cpu")
    load_flax(model, params, stats)

    layers = list(_lsq_layers(params))
    assert len(layers) == 28
    modules = dict(model.named_modules())
    cb = jcb.lsq_fibbinary_codebook(8) if fibbinary else None
    for path, kernel, step in layers:
        m = modules[path]
        assert isinstance(m, tlsq.DenseLSQ) and m.use_pallas == use_pallas
        np.testing.assert_array_equal(
            _torch_codes(m.weight.detach(), m.step_size.detach(), 8, m.codebook),
            _jax_codes(np.asarray(kernel), np.asarray(step), 8, cb).T, err_msg=path)

    with torch.no_grad():
        got = model(torch.from_numpy(x_enc), torch.from_numpy(x_dec)).numpy()
    want = jax.jit(fmod.apply)({"params": params, "batch_stats": stats},
                               jnp.asarray(x_enc), jnp.asarray(x_dec))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_lsq_model_init_and_codebook_placement():
    """Each DenseLSQ draws its weight as a dense layer does (so the LSQ
    model of a seed has the FP32 model's weights) and sets step_size =
    mean|w| / sqrt(Qp); the codebook is a non-persistent buffer."""
    from channelestimationtransformer_torch.models.informer import build_informer

    cfg = InformerConfig(**SMALL)
    lsq = build_informer_lsq(cfg, nbits=4, fibbinary=True, device="cpu", seed=2)
    fp32 = build_informer(cfg, device="cpu", seed=2).state_dict()
    sd = lsq.state_dict()
    assert set(sd) - set(fp32) == {k for k in sd if k.endswith("step_size")}
    assert all(torch.equal(fp32[k], sd[k]) for k in fp32)
    for m in lsq.modules():
        if isinstance(m, tlsq.DenseLSQ):
            assert m.step_size.item() == pytest.approx(m.weight.abs().mean().item() / 7 ** 0.5)
            assert m.codebook.tolist() == lsq_fibbinary_codebook(4).tolist()
    assert not any(k.endswith("codebook") for k in sd)
    plain = build_informer_lsq(cfg, nbits=4, device="cpu")
    assert all(m.codebook is None for m in plain.modules() if isinstance(m, tlsq.DenseLSQ))


def test_flagship_lsq_fibbinary_forward_snaps_72_tensors(monkeypatch):
    """InformerConfig(use_pallas=True, lsq_nbits=8, lsq_fibbinary=True):
    one eval forward snaps each of the 72 projection and FFN weights once
    through the kernel wrapper, with the 67-entry codebook."""
    calls = []
    real = tlsq.nearest_codeword
    monkeypatch.setattr(tlsq, "nearest_codeword", lambda x, cb: (
        calls.append((tuple(x.shape), cb.numel())) or real(x, cb)))
    model = build_informer_lsq(InformerConfig(use_pallas=True), nbits=8, fibbinary=True,
                               device="cpu")
    with torch.no_grad():
        out = model(torch.randn(1, 90, 16), torch.randn(1, 15, 16))
    assert out.shape == (1, 5, 16) and torch.isfinite(out).all()
    assert len(calls) == 72 and {n for _, n in calls} == {67}
    assert sorted(calls).count(((128, 128), 67)) == 52
