"""The quantization study's ops and drivers in the port against the JAX
package's, on the CPU.

- ``fixed_point_quantize_with_mask``, the partial quantizers (proximal,
  distant) and ``block_quantize`` / ``float_quantize`` with nearest
  rounding: exactly equal to JAX's, on inputs with ties, out-of-range
  values and +-0. The partial threshold's index is JAX's with a float32
  fraction (the drivers' ``jnp.float32(pct)``), and float32 and float64
  give the same index at every fraction of the three schedules and every
  epoch of the prune ramp at the flagship's sizes.
- Stochastic rounding and the stochastic subset draw other bits than JAX:
  checked by statistics (within 4 sigma) and against the port's own Philox
  uniform exactly.
- ``ste`` and ``quantizer``: values and gradients exactly equal to
  ``jax.grad`` of JAX's (nearest rounding), with ``clamping_grad_zero``
  and backward formats.
- The grouped partial transforms (``many``) equal the per-tensor path bit
  for bit and JAX tensor by tensor, at every schedule fraction, 0 and 1.
- ``quantize_grads_`` then Adam against ``optax.chain(quantize_grads, adam)``
  (rtol 1e-6 / atol 1e-7, the optimizer tests' tolerance);
  ``quantize_activations`` against flax's interceptor on a small
  InformerStack (rtol 2e-4 / atol 2e-5 and the same layers hit).
- One QAT step (``_update``, then the transform) against JAX's: parameters,
  and the gradients Adam's moments hold, at the training tests' rtol 2e-4 /
  atol 2e-5, and the moments still keyed by the same ``Parameter`` objects.
- The schedule of ``TrainConfig(lr=1e-4)`` at steps 22,599 and on (0 from
  22,600) against optax.
- The three drivers: flags read from ``experiments/*.py``'s source, a tiny
  CPU run of each (files, keys, the pickle order), and none runs without a
  card unless asked for the CPU.
"""

import functools
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from channelestimationtransformer_tpu.core.config import TrainConfig as JaxTrainConfig
from channelestimationtransformer_tpu.ops import quant as jq
from channelestimationtransformer_tpu.ops.quant import auto_low as jauto
from channelestimationtransformer_tpu.ops.quant import formats as jformats
from channelestimationtransformer_tpu.ops.quant import optim as joptim
from channelestimationtransformer_tpu.ops.quant import settings as jq_settings
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update
from channelestimationtransformer_tpu.train.trainer import make_schedule as jax_make_schedule

from channelestimationtransformer_torch.cli import _study, prune, ptq_sweep, qat_incremental
from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.models.attention import Dense
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.ops import quant as tq
from channelestimationtransformer_torch.ops.cuda.bd_attention import draw_seed
from channelestimationtransformer_torch.ops.cuda.quant import stochastic_uniform
from channelestimationtransformer_torch.ops.quant import functional as tfn
from channelestimationtransformer_torch.ops.quant.auto_low import quantize_activations
from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
from channelestimationtransformer_torch.train.trainer import (
    _update,
    apply_gradients,
    create_train_state,
    make_schedule,
)
from channelestimationtransformer_torch.utils.convert import from_flax, load_flax

from test_torch_cli import ROOT, _jax_flags, _port_flags
from test_torch_informer import SMALL, _model_pair

RTOL, ATOL = 2e-4, 2e-5
SCHEDULES = qat_incremental.SCHEDULES
FRACTIONS = sorted({0.0, *(p for s in SCHEDULES.values() for p in s)})
SMALL_CFG = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread here: these tests run many small ops, which the
    default intra-op pool slows several-fold when the machine is shared (as
    under pytest-xdist's workers); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(shape, seed, scale=0.3, grid=None):
    """Seeded weights; on a grid of ``grid`` steps (ties in |x - q|) if given."""
    x = scale * np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if grid:
        x = np.round(x * grid) / grid
    x.reshape(-1)[:3] = [0.0, -0.0, 9.0]  # +-0 and a value past every clamp
    return x.astype(np.float32)


# --- fixed point with mask -------------------------------------------------------

@pytest.mark.parametrize("wl,fl,symmetric", [(4, 2, False), (6, 3, True), (2, -2, False)])
def test_fixed_point_quantize_with_mask_matches_jax(wl, fl, symmetric):
    x = _weights((37, 11), wl, scale=2.0 ** (wl - fl - 1))
    q, mask = tq.fixed_point_quantize_with_mask(torch.from_numpy(x), wl, fl, symmetric=symmetric)
    jq_, jmask = jq.functional.fixed_point_quantize_with_mask(jnp.asarray(x), wl, fl, symmetric=symmetric)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < mask.sum() < mask.numel()
    # Stochastic: the mask marks exactly the clamped elements of its own draw.
    q, mask = tq.fixed_point_quantize_with_mask(torch.from_numpy(x), wl, fl, symmetric=symmetric,
                                                rounding="stochastic",
                                                generator=torch.Generator().manual_seed(1))
    raw = tq.fixed_point_quantize(torch.from_numpy(x), wl, fl, clamp=False, rounding="stochastic",
                                  generator=torch.Generator().manual_seed(1))
    lo, hi = jq.functional._fixed_bounds(wl, fl, symmetric)
    assert torch.equal(mask, (raw > hi) | (raw < lo)) and torch.equal(q, raw.clamp(lo, hi))


# --- the partial threshold ---------------------------------------------------------

def test_threshold_index_is_float32_and_equals_float64_on_the_study_grids():
    """Every fraction of the three QAT schedules at the flagship's two
    numels, and every epoch of the prune ramp at its two block counts: the
    port's index is JAX's ``int32(float32 p * (n - 1))``, and float64 gives
    the same one."""
    args = prune.build_parser().parse_args(["--device", "cpu"])
    ramp = [prune.epoch_sparsity(e, args) for e in range(args.epochs)]
    for points, sizes in ((FRACTIONS, (16384, 8192)), (ramp, (4096, 2048))):
        for n in sizes:
            jk = np.asarray(jnp.asarray(jnp.asarray(points, jnp.float32) * (n - 1), jnp.int32))
            for p, j in zip(points, jk):
                assert tfn._threshold_index(p, n) == j == int(p * (n - 1)), (p, n)


PARTIAL_CASES = [(r, c, s) for r in ("proximal", "distant")
                 for c, s in ((True, False), (False, False), (True, True))]


@pytest.mark.parametrize("rounding,clamp,symmetric", PARTIAL_CASES)
def test_fixed_point_partial_matches_jax(rounding, clamp, symmetric):
    """On a grid of 1/64 (so many ties in |x - q|), at fractions 0 to 1 as
    traced float32 values, as the QAT driver passes them."""
    x = _weights((24, 40), 3, grid=64)
    jfn = jax.jit(lambda v, p: jq.fixed_point_quantize_partial(
        v, p, 6, 3, clamp=clamp, symmetric=symmetric, rounding=rounding))
    for p in (0.0, 0.001, 0.3, 0.5, 0.85, 0.9999, 1.0):
        got = tq.fixed_point_quantize_partial(torch.from_numpy(x), p, 6, 3, clamp=clamp,
                                              symmetric=symmetric, rounding=rounding)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(x, jnp.float32(p))), str(p))


@pytest.mark.parametrize("rounding", ["proximal", "distant"])
@pytest.mark.parametrize("wl,fl", [(2, -2), (6, 3)])
def test_fibonacci_partial_matches_jax(rounding, wl, fl):
    x = _weights((16, 33), 4, scale=2.0 ** (wl - fl - 1), grid=2 ** max(fl, 0))
    jfn = jax.jit(lambda v, p: jq.fibonacci_quantize_partial(v, wl, fl, p, rounding=rounding))
    for p in (0.0, 0.3, 0.7, 0.98, 1.0):
        got = tq.fibonacci_quantize_partial(torch.from_numpy(x), wl, fl, p, rounding=rounding)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(x, jnp.float32(p))), str(p))


def test_partial_rejects_unknown_roundings_and_needs_a_generator():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="rounding"):
        tq.fixed_point_quantize_partial(x, 0.5, 4, 2, rounding="nearest")
    with pytest.raises(ValueError, match="rounding"):
        tq.FibbinaryPartialWeightQuant(2, -2, "nearest")
    with pytest.raises(ValueError, match="Generator"):
        tq.FixedPointPartialWeightQuant(4, 2, "stochastic")(x, 0.5)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.95])
def test_stochastic_partial_takes_a_fraction_within_4_sigma(p):
    """The subset is ``u < p`` with the fixed-point kernel's own ``u``
    (exactly), taken elements are quantized and the others kept; the taken
    share is ``p`` within 4 sigma, as JAX's is."""
    x = _weights((256, 256), 5)
    gen = torch.Generator().manual_seed(11)
    got = tq.fixed_point_quantize_partial(torch.from_numpy(x), p, 4, 2, rounding="stochastic",
                                          generator=gen)
    seed = draw_seed(torch.Generator().manual_seed(11), "cpu")
    q = tq.fixed_point_quantize(torch.from_numpy(x), 4, 2)
    take = stochastic_uniform(seed, x.size, 0).view(x.shape) < np.float32(p)
    assert torch.equal(got, torch.where(take, q, torch.from_numpy(x)).clamp(-2.0, 1.75))
    sigma = np.sqrt(p * (1 - p) / x.size)
    assert abs(take.float().mean().item() - p) < 4 * sigma
    jtake = np.asarray(jax.random.uniform(jax.random.key(0), x.shape) < p)
    assert abs(jtake.mean() - p) < 4 * sigma


# --- the grouped transforms ----------------------------------------------------------

def _group(seed, scale=0.3):
    """Two numel classes in interleaved name order, as the flagship's
    attention (16 x 16 here) and FFN (8 x 16, 16 x 8) weights."""
    shapes = [(16, 16), (8, 16), (16, 16), (16, 8), (16, 16), (8, 16), (16, 16)]
    return [_weights(s, seed + i, scale=scale, grid=32) for i, s in enumerate(shapes)]


def _transform(codebook, rounding):
    return (tq.FibbinaryPartialWeightQuant(2, -2, rounding) if codebook == "fibonacci"
            else tq.FixedPointPartialWeightQuant(4, 2, rounding))


@pytest.mark.parametrize("codebook", ["fixed", "fibonacci"])
@pytest.mark.parametrize("rounding", ["proximal", "distant"])
def test_grouped_partial_equals_per_tensor_and_jax_at_every_fraction(codebook, rounding):
    arrays = _group(7, scale=3.0 if codebook == "fibonacci" else 0.3)
    tensors = [torch.from_numpy(a) for a in arrays]
    fn = _transform(codebook, rounding)
    if codebook == "fibonacci":
        jfn = jax.jit(lambda v, p: jq.fibonacci_quantize_partial(v, 2, -2, p, rounding=rounding))
    else:
        jfn = jax.jit(lambda v, p: jq.fixed_point_quantize_partial(v, p, 4, 2, rounding=rounding))
    for p in FRACTIONS:
        got = fn.many(tensors, p)
        for a, t, g in zip(arrays, tensors, got):
            assert torch.equal(g, fn(t, p)), p
            np.testing.assert_array_equal(g.numpy(), np.asarray(jfn(a, jnp.float32(p))), str(p))


@pytest.mark.parametrize("codebook", ["fixed", "fibonacci"])
def test_grouped_stochastic_partial_draws_stream_t(codebook):
    """One seed for the group, tensor t's subset from Philox stream t; a
    group of one is the per-tensor call."""
    tensors = [torch.from_numpy(a) for a in _group(9)]
    fn = _transform(codebook, "stochastic")
    p = 0.6
    got = fn.many(tensors, p, torch.Generator().manual_seed(5))
    seed = draw_seed(torch.Generator().manual_seed(5), "cpu")
    exact = _transform(codebook, "proximal")
    for t, (x, g) in enumerate(zip(tensors, got)):
        q = exact(x, 1.0)
        take = stochastic_uniform(seed, x.numel(), t).view(x.shape) < np.float32(p)
        want = torch.where(take, q, x)
        bounds = (0.0, 8.0) if codebook == "fibonacci" else (-2.0, 1.75)
        assert torch.equal(g, want.clamp(*bounds)), t
    for x in tensors[:2]:
        assert torch.equal(fn.many([x], p, torch.Generator().manual_seed(3))[0],
                           fn(x, p, torch.Generator().manual_seed(3)))


def test_grouped_transform_takes_one_snap_and_apply_weight_quant_gathers_it(monkeypatch):
    """Through apply_weight_quant one partial quantizer is one many() call:
    one fixed-point (or codeword) call over all the tensors and one sort a
    numel class, where the per-tensor path takes one of each a tensor."""
    model = build_informer(InformerConfig(**SMALL_CFG), device="cpu", seed=2)
    params = dict(model.named_parameters())
    counts = {"fixed": 0, "codeword": 0, "sort": 0}
    spies = ((tfn, "fused_fixed_point_quantize", "fixed"), (tfn, "nearest_codeword", "codeword"),
             (torch, "sort", "sort"))
    for module, name, key in spies:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, functools.partial(
            lambda real, key, *a, **k: counts.__setitem__(key, counts[key] + 1) or real(*a, **k),
            real, key))
    for fn, key in ((tq.FixedPointPartialWeightQuant(2, -2), "fixed"),
                    (tq.FibbinaryPartialWeightQuant(2, -2), "codeword")):
        settings = tq.build_weight_quant_settings(params, fn)
        counts.update(fixed=0, codeword=0, sort=0)
        with torch.no_grad():
            got = tq.apply_weight_quant(params, settings, percentage=0.7)
        classes = {params[n].numel() for n in settings.settings}
        assert counts[key] == 1 and counts["sort"] == len(classes) == 2
        counts.update(fixed=0, codeword=0, sort=0)
        with torch.no_grad():
            for name in settings.settings:
                assert torch.equal(got[name], fn(params[name], 0.7)), name
        assert counts[key] == counts["sort"] == len(settings) == 28


# --- block and float formats ----------------------------------------------------------

def _away_from_log2_edge(x):
    """Block maxima kept off the float32 log2 round-up just below a power of
    two (there JAX and the port agree only because both use log2)."""
    frac = np.abs(x).max() / 2.0 ** np.floor(np.log2(np.abs(x).max()))
    assert 1.0 <= frac < 1.999
    return x


@pytest.mark.parametrize("wl", [4, 8])
@pytest.mark.parametrize("dim", [-1, 0, 1])
def test_block_quantize_nearest_matches_jax(wl, dim):
    x = _away_from_log2_edge(_weights((24, 16), wl + dim, scale=1.3))
    x[5, 3] = 1.5  # rows whose max sits mid-octave
    got = tq.block_quantize(torch.from_numpy(x), wl, dim=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.block_quantize(jnp.asarray(x), wl,
                                                                             dim=dim)))


def test_block_quantize_stochastic_statistics():
    """On the grid, within one step, unbiased within 4 sigma."""
    x = np.full((200_000,), 0.3, np.float32)
    x[0] = 1.5  # max 1.5: exponent 0, step 2^-(wl-2) = 1/64 at wl 8
    got = tq.block_quantize(torch.from_numpy(x), 8, rounding="stochastic",
                            generator=torch.Generator().manual_seed(0)).numpy()
    assert set(np.unique(got[1:] * 64)) <= {19.0, 20.0}
    frac = 0.3 * 64 - 19
    sigma = np.sqrt(frac * (1 - frac) / (x.size - 1)) / 64
    assert abs(got[1:].mean() - 0.3) < 4 * sigma


FLOAT_FORMATS = [(5, 2), (4, 3), (8, 7), (5, 10), (8, 23), (3, 1)]


def _float_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=4096) * np.exp2(rng.integers(-20, 20, size=4096))).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e30, -1e30, 2.0 ** -14, 3 * 2.0 ** -17, 1.0 + 2.0 ** -3, 65504.0]
    return x


@pytest.mark.parametrize("exp,man", FLOAT_FORMATS)
def test_float_quantize_nearest_matches_jax(exp, man):
    """Exactly JAX's, but for +-0 at exp 8: there the subnormal grid's
    spacing 2^-(126 + man) is itself a float32 subnormal, which XLA on the
    CPU flushes to zero, so JAX's 0 / 0 gives NaN; the port keeps +-0."""
    x = _float_inputs(exp * 31 + man)
    got = tq.float_quantize(torch.from_numpy(x), exp, man).numpy()
    want = np.asarray(jq.float_quantize(jnp.asarray(x), exp, man))
    if exp == 8:
        assert np.isnan(want[x == 0]).all() and not np.isnan(want[x != 0]).any()
        want = np.where(x == 0, x, want)
    np.testing.assert_array_equal(got, want)


def test_float_quantize_stochastic_statistics():
    """E5M2: a normal value lands on one of its two neighbours, unbiased
    within 4 sigma; so does a value on the subnormal grid."""
    for value, lo, hi in ((1.1, 1.0, 1.25), (1.25 * 2.0 ** -16, 2.0 ** -16, 2.0 ** -15)):
        x = np.full(200_000, value, np.float32)
        got = tq.float_quantize(torch.from_numpy(x), 5, 2, rounding="stochastic",
                                generator=torch.Generator().manual_seed(1)).numpy()
        assert set(np.unique(got)) <= {np.float32(lo), np.float32(hi)}
        frac = (np.float32(value) - lo) / (hi - lo)
        sigma = np.sqrt(frac * (1 - frac) / x.size) * (hi - lo)
        assert abs(got.astype(np.float64).mean() - np.float32(value)) < 4 * sigma


# --- ste and quantizer ---------------------------------------------------------------

def test_ste_gradient_is_the_identity():
    x = _weights((9, 7), 1)
    ct = _weights((9, 7), 2)
    jfn = lambda v: jq.ste(v, lambda u: jq.fixed_point_quantize(u, 4, 2))  # noqa: E731
    want_grad = jax.grad(lambda v: jnp.sum(jfn(v) * ct))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = tq.ste(t, lambda u: tq.fixed_point_quantize(u, 4, 2))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jfn(jnp.asarray(x))))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want_grad))


QUANTIZER_CASES = [
    dict(forward_number="fixed", backward_number=None, clamping_grad_zero=False),
    dict(forward_number="fixed", backward_number=None, clamping_grad_zero=True),
    dict(forward_number="fixed", backward_number="fixed8", clamping_grad_zero=True),
    dict(forward_number="float", backward_number="float", clamping_grad_zero=False),
    dict(forward_number="block", backward_number="block", clamping_grad_zero=True),
    dict(forward_number=None, backward_number="fixed8", clamping_grad_zero=False),
]


def _numbers(formats):
    return {None: (None, None),
            "fixed": (tq.FixedPoint(4, 2), jformats.FixedPoint(4, 2)),
            "fixed8": (tq.FixedPoint(8, 6), jformats.FixedPoint(8, 6)),
            "float": (tq.FloatingPoint(5, 2), jformats.FloatingPoint(5, 2)),
            "block": (tq.BlockFloatingPoint(6), jformats.BlockFloatingPoint(6))}[formats]


@pytest.mark.parametrize("case", QUANTIZER_CASES)
def test_quantizer_values_and_gradients_match_jax(case):
    """Nearest rounding both ways: the forward and the gradient of
    ``sum(fn(x) * ct)`` equal ``jax.grad`` of JAX's quantizer exactly."""
    x = _weights((13, 10), 6, scale=1.5)
    ct = _weights((13, 10), 7, scale=0.05)
    fwd, bwd = _numbers(case["forward_number"]), _numbers(case["backward_number"])
    jfn = jq.quantizer(forward_number=fwd[1], backward_number=bwd[1],
                       clamping_grad_zero=case["clamping_grad_zero"])
    tfn_ = tq.quantizer(forward_number=fwd[0], backward_number=bwd[0],
                        clamping_grad_zero=case["clamping_grad_zero"])
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = tfn_(t)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))
    with torch.no_grad():  # no gradient taken: the forward format alone
        np.testing.assert_array_equal(tfn_(torch.from_numpy(x)).numpy(), np.asarray(want))
    if case["clamping_grad_zero"] and case["forward_number"] == "fixed":
        assert (t.grad == 0).any()


def test_quantizer_stochastic_draws_from_its_generator():
    x = torch.from_numpy(_weights((64, 64), 8)).requires_grad_()
    fn = tq.quantizer(forward_number=tq.FixedPoint(4, 2), backward_number=tq.FixedPoint(8, 6),
                      forward_rounding="stochastic", backward_rounding="stochastic")
    outs, grads = [], []
    for seed in (0, 0, 1):
        x.grad = None
        out = fn(x, torch.Generator().manual_seed(seed))
        out.backward(torch.full_like(out, 0.013))
        outs.append(out.detach())
        grads.append(x.grad.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert not torch.equal(outs[0], outs[2])
    assert set(torch.unique(grads[0] * 64).tolist()) <= {0.0, 1.0}
    assert torch.equal(fn(x), fn(x, torch.Generator().manual_seed(0)))  # JAX's key(0)


# --- gradient quantization ---------------------------------------------------------

def test_quantize_grads_then_adam_matches_optax():
    rng = np.random.default_rng(23)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    kwargs = dict(num_epochs=1, steps_per_epoch=30, lr=1e-2)
    tx = optax.chain(joptim.quantize_grads(lambda g: jq.fixed_point_quantize(g, 6, 4)),
                     optax.adam(jax_make_schedule(JaxTrainConfig(**kwargs))))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    for quant_fn in (lambda g: tq.fixed_point_quantize(g, 6, 4), tq.FixedPointWeightQuant(6, 4)):
        module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                         for k, v in params.items()})
        state = create_train_state(module, TrainConfig(**kwargs))
        for g in grads:
            for k, p in module.items():
                p.grad = torch.from_numpy(g[k].copy())
            grad_objects = [p.grad for p in module.values()]
            tq.quantize_grads_(module.values(), quant_fn)
            assert all(a is p.grad for a, p in zip(grad_objects, module.values()))
            assert all(torch.equal(p.grad, tq.fixed_point_quantize(torch.from_numpy(g[k]), 6, 4))
                       for k, p in module.items())
            apply_gradients(state)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# --- activation quantization --------------------------------------------------------

def test_quantize_activations_matches_flax_intercept():
    """Every Dense output (the port's ``Dense``, flax's ``nn.Dense``) through
    fixed point (24, 16) in both, on the small InformerStack: the same number
    of layers hit, outputs within rtol 2e-4 / atol 2e-5 (a pre-quantization
    difference of ~1e-6 can move a value one grid step of 2^-16 now and
    then); the hook is gone after the context."""
    rng = np.random.default_rng(31)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 2, **SMALL)
    hits = {"flax": 0, "port": 0}

    def jfn(v):
        hits["flax"] += 1
        return jq.fixed_point_quantize(v, 24, 16)

    def tfn_(v):
        hits["port"] += 1
        return tq.fixed_point_quantize(v, 24, 16)

    with jauto.quantize_activations(jfn):  # the interceptor acts while jit traces
        want = jax.jit(fmod.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x_enc),
                                   jnp.asarray(x_dec))
    with torch.no_grad():
        plain = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
        with quantize_activations(tfn_):
            got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
        after = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    n_dense = sum(isinstance(m, Dense) for m in tmod.modules())
    assert hits["port"] == hits["flax"] == n_dense
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(after, plain) and not torch.equal(got, plain)


# --- one QAT step -------------------------------------------------------------------

def _flax_name(name):
    return name.replace("/", ".").removesuffix("kernel") + "weight"


@pytest.fixture(scope="module")
def qat_update():
    """The small InformerStack after one JAX ``_update`` with Adam at lr 1e-4
    (the QAT driver's) at dropout 0, with the weights, batch and state."""
    rng = np.random.default_rng(50)
    fmod, _, params, stats, x_enc, x_dec = _model_pair(rng, 3, **SMALL)
    target = rng.normal(size=(3, SMALL["pred_len"], 16)).astype(np.float32)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=optax.adam(jax_make_schedule(JaxTrainConfig(lr=1e-4))))
    key = jax.random.key(0)
    state, _ = jax.jit(jax_update)(state, *map(jnp.asarray, (x_enc, x_dec, target)), key, key)
    return params, stats, (x_enc, x_dec, target), state


@pytest.mark.parametrize("codebook,rounding", [("fixed", "proximal"), ("fibonacci", "proximal"),
                                               ("fixed", "distant")])
def test_qat_step_matches_jax(codebook, rounding, qat_update):
    """``_update`` with Adam at lr 1e-4, then the partial transform at
    fraction 0.7 (wl 2, fl -2) written into the parameters, on the small
    InformerStack at dropout 0: parameters and Adam's moments against JAX's
    ``_update`` then ``apply_weight_quant``."""
    params, stats, batch, state = qat_update
    pct = 0.7
    if codebook == "fibonacci":
        jfn = lambda w, p, k: jq.fibonacci_quantize_partial(w, 2, -2, p, rounding=rounding)  # noqa: E731
    else:
        jfn = lambda w, p, k: jq.fixed_point_quantize_partial(w, p, 2, -2, rounding=rounding)  # noqa: E731
    jset = jq_settings.build_weight_quant_settings(state.params, jfn)
    jparams = jq.apply_weight_quant(state.params, jset, percentage=jnp.float32(pct))
    want = from_flax(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, state.batch_stats))
    adam = state.opt_state[0]
    want_mu, want_nu = (from_flax(jax.tree.map(np.asarray, m), stats) for m in (adam.mu, adam.nu))

    tmod = build_informer(InformerConfig(**SMALL), device="cpu")
    load_flax(tmod, params, stats)
    tstate = create_train_state(tmod, TrainConfig(lr=1e-4))
    _update(tstate, *map(torch.from_numpy, batch), torch.Generator())
    tparams = dict(tmod.named_parameters())
    fn = (tq.FibbinaryPartialWeightQuant(2, -2, rounding) if codebook == "fibonacci"
          else tq.FixedPointPartialWeightQuant(2, -2, rounding))
    settings = tq.build_weight_quant_settings(tmod.state_dict(), fn)
    assert sorted(settings.settings) == sorted(map(_flax_name, jset.settings))
    moments = {name: tstate.optimizer.state[p] for name, p in tparams.items()}
    before = {n: {k: v.clone() for k, v in m.items()} for n, m in moments.items()}
    with torch.no_grad():
        tq.assign_(tparams, tq.apply_weight_quant(tparams, settings, percentage=pct))
    assert all(p is q for p, q in zip(tparams.values(), tmod.parameters()))
    for name, p in tparams.items():
        m = tstate.optimizer.state[p]
        assert m is moments[name] and all(torch.equal(m[k], before[name][k]) for k in m)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        # After one update mu = 0.1 g and nu = 0.001 g^2: the gradients they
        # hold, at the training tests' gradient tolerance.
        np.testing.assert_allclose(m["exp_avg"].numpy() / 0.1, want_mu[name].numpy() / 0.1,
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(np.sqrt(m["exp_avg_sq"].numpy() / 1e-3),
                                   np.sqrt(want_nu[name].numpy() / 1e-3), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    quantized = [tparams[n] for n in settings.settings]
    grid = np.concatenate([p.detach().numpy().reshape(-1) for p in quantized])
    on_grid = np.isin(grid, [0.0, 4.0, 8.0] if codebook == "fibonacci" else [-8.0, -4.0, 0.0,
                                                                               4.0])
    assert on_grid.mean() >= pct


def test_qat_schedule_reaches_zero_at_step_22600():
    """The QAT driver's ``TrainConfig(lr=1e-4)`` (100 x 226 steps): the lr
    against optax at 22,599 and after; 0 from 22,600 to the end of a
    40,680-step schedule."""
    port = make_schedule(TrainConfig(lr=1e-4))
    ref = jax_make_schedule(JaxTrainConfig(lr=1e-4))
    for step in (22_599, 22_600, 22_601, 40_679, 45_199):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step
    assert port(22_599) > 0 and port(22_600) == port(40_679) == 0.0


# --- the drivers ---------------------------------------------------------------------

CHANNEL_FLAGS = ("--slot-symbols", "--ue-speed-kmh", "--calibrated")


@pytest.mark.parametrize("driver,cli", [("experiments/ptq_sweep.py", ptq_sweep),
                                        ("experiments/qat_incremental.py", qat_incremental),
                                        ("experiments/prune.py", prune)])
def test_driver_flags_match_the_jax_driver(driver, cli):
    """Every flag of the JAX driver (its own and ``add_channel_args``'s)
    with its default, type, choices and nargs; the port adds ``--device``
    and ``--use-pallas``."""
    want = _jax_flags(driver)
    channel = {k: v for k, v in _jax_flags("channelestimationtransformer_tpu/channel/cdl.py").items()
               if k in CHANNEL_FLAGS}
    want.update(channel)
    got = _port_flags(cli.build_parser())
    assert set(got) == set(want) | {"--device", "--use-pallas"}
    for flag in want:
        assert got[flag] == want[flag], flag
    assert got["--device"]["default"] is None and got["--use-pallas"]["default"] is False


def test_qat_schedules_are_the_jax_drivers():
    import ast

    tree = ast.parse((ROOT / "experiments/qat_incremental.py").read_text())
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "SCHEDULES"]
    assert ast.literal_eval(node.value) == SCHEDULES


@pytest.fixture
def small_drivers(monkeypatch, tmp_path):
    """The drivers on the small model at batch 16, their datasets cut to 64
    samples (the JAX drivers fix 2,048 validation samples, whose channel
    generation is most of a CPU run), and an FP32 checkpoint of the model."""
    def datasets(args, cfg, device, *specs):
        return _study.datasets(args, cfg, device, *((key, min(n, 64)) for key, n in specs))

    for module in (ptq_sweep, qat_incremental, prune):
        monkeypatch.setattr(module, "InformerConfig",
                            functools.partial(InformerConfig, **SMALL_CFG))
        monkeypatch.setattr(module, "TrainConfig", functools.partial(TrainConfig, batch_size=16))
        monkeypatch.setattr(module, "datasets", datasets)
    fp32 = build_informer(InformerConfig(**SMALL_CFG), device="cpu", seed=1)
    return save_checkpoint(create_train_state(fp32, TrainConfig()), str(tmp_path), "fp32_", 3)


def test_ptq_sweep_writes_results_and_pickles_in_sorted_order(small_drivers, tmp_path, capsys):
    out = tmp_path / "ptq" / "ptq_results.json"
    results = ptq_sweep.main(["--device", "cpu", "--checkpoint", small_drivers, "--wl-min", "8",
                              "--wl-max", "10", "--val-samples", "64", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Loaded checkpoint (epoch 3)"
    on_disk = json.loads(out.read_text())
    keys = ["fp32"] + [f"{r}_wl{wl}_fl{wl - 4}" for r in ("nearest", "stochastic")
                       for wl in (8, 9, 10)]
    assert list(on_disk) == keys and json.loads(json.dumps(results)) == on_disk
    assert all(len(v[0]) == 5 and np.isfinite(v[1]) for v in on_disk.values())
    for rounding in ("nearest", "stochastic"):
        with open(out.parent / f"loss_list_{rounding}.pkl", "rb") as f:
            got = pickle.load(f)
        # sorted(): wl10 before wl8 and wl9, as the JAX driver writes them.
        assert got == [on_disk[f"{rounding}_wl{wl}_fl{wl - 4}"][0] for wl in (10, 8, 9)]
    assert json.loads(lines[-1]) == {"sweep": "ptq", "entries": 7}
    # The same draws for every row: a wl far past the weights' range is FP32.
    assert abs(on_disk["nearest_wl10_fl6"][1] - on_disk["fp32"][1]) < abs(
        on_disk["nearest_wl8_fl4"][1] - on_disk["fp32"][1]) + 1e-3


@pytest.mark.parametrize("argv,tag,fractions,setting", [
    (["--codebook", "fibonacci"], "wl2_fl-2_proximal_partial_fibonacci", SCHEDULES["proximal"],
     "wl=2 fl=-2 proximal/partial/fibonacci"),
    (["--rounding", "stochastic", "--wl", "4", "--fl", "2"], "wl4_fl2_stochastic_partial_fixed",
     SCHEDULES["stochastic"], "wl=4 fl=2 stochastic/partial/fixed"),
    (["--setting", "full", "--rounding", "distant"], "wl2_fl-2_distant_full_fixed", [1.0],
     "wl=2 fl=-2 distant/full/fixed"),
])
def test_qat_incremental_writes_its_files(small_drivers, tmp_path, capsys, monkeypatch, argv, tag,
                                          fractions, setting):
    """A step a fraction (70 epochs in the full setting); the per-fraction
    results, the JSON, the checkpoint and the last line."""
    steps, real_train_step = [], qat_incremental.train_step
    monkeypatch.setattr(qat_incremental, "train_step",
                        lambda *a, **k: steps.append(1) or real_train_step(*a, **k))
    out = tmp_path / "qat"
    results = qat_incremental.main(["--device", "cpu", "--checkpoint", small_drivers,
                                    "--epochs-per-step", "1", "--steps-per-epoch", "1",
                                    "--train-samples", "64", "--out", str(out), *argv])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [f"Preloaded {small_drivers}", f"Quantizing 28 weight tensors; {setting}"]
    assert [r["fraction"] for r in results] == fractions
    assert len(steps) == len(fractions) * (70 if "full" in argv else 1)
    assert json.loads((out / f"qat_{tag}.json").read_text()) == results
    assert (out / f"qat_{tag}_{len(fractions)}.pt").exists()
    assert json.loads(lines[-1]) == {"sweep": "qat", "tag": tag, "final": results[-1]}
    assert all(np.isfinite(r["val_nmse"]) and len(r["val_split"]) == 5 for r in results)


def test_prune_writes_its_files(small_drivers, tmp_path, capsys):
    out = tmp_path / "prune"
    results = prune.main(["--device", "cpu", "--checkpoint", small_drivers, "--epochs", "3",
                          "--steps-per-epoch", "2", "--train-samples", "64", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert [r["sparsity"] for r in results] == [0.0, 0.8667, 0.9]  # the ramp ends at step 3
    assert results[0]["measured_sparsity"] == 0.0 and results[-1]["measured_sparsity"] > 0.85
    assert json.loads((out / "prune_results.json").read_text()) == results
    assert (out / "pruned_3.pt").exists()
    assert json.loads(lines[-1]) == {"sweep": "prune", "final": results[-1]}


def test_study_drivers_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli, argv in ((ptq_sweep, ["--checkpoint", "x.pt", "--out", str(tmp_path / "r.json")]),
                      (qat_incremental, ["--out", str(tmp_path)]),
                      (prune, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert not any(tmp_path.iterdir())
