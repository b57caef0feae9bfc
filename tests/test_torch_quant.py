"""The port's quantization ops on the CPU against the JAX package's.

- Fixed point, nearest rounding: the plain version (which the kernel
  wrapper runs on a CPU tensor) against JAX ``fixed_point_quantize`` and
  against the TPU kernel ``_fixed_kernel`` in Pallas interpret mode, exactly,
  over (wl, fl, symmetric, clamp) with fl < 0 and fl > wl, on inputs that
  hold exact midpoints, out-of-range values and +-0.
- Fixed point, stochastic: JAX draws other random bits, so it is checked by
  statistics: every output is one of the two neighbouring grid points (or
  the clamp bound) and the mean is unbiased within 4 sigma; and the plain
  version is ``floor(x * 2^fl + u) / 2^fl`` with the kernel's ``u``.
- Nearest codeword: the plain version against JAX ``nearest_codeword`` and
  ``_codeword_kernel`` in interpret mode, exactly, with ties, out-of-range
  values and +-0, on sorted and unsorted codebooks; the codebooks equal JAX's.
- PTQ: ``apply_weight_quant`` of the port (nearest) gives, exactly, the
  tensors that ``from_flax`` makes of JAX's quantized params; the quantized
  eval forward matches flax within rtol 2e-4 / atol 2e-5; at the flagship
  both select the same 72 tensors.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.ops import quant as jq
from channelestimationtransformer_tpu.ops.pallas.quant import _codeword_kernel, _fixed_kernel
from channelestimationtransformer_tpu.ops.quant import settings as jq_settings

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.ops import quant as tq
from channelestimationtransformer_torch.ops.cuda.bd_attention import philox4x32_10
from channelestimationtransformer_torch.ops.cuda.quant import (
    fused_fixed_point_quantize,
    fused_nearest_codeword,
    nearest_codeword_reference,
    stochastic_uniform,
)
from channelestimationtransformer_torch.utils.convert import from_flax, load_flax

# (wl, fl): chip_smoke.py's formats, and fl > wl (a range below 1).
FORMATS = [(8, 4), (4, 0), (15, 11), (2, -2), (5, 7)]
SMALL = dict(seq_len=24, label_len=6, pred_len=5, d_model=32, n_heads=4,
             e_layers=(2, 1), d_layers=1, d_ff=32, dropout=0.0)


def _fixed_inputs(wl, fl, seed=0):
    """Normal values over twice the format's range, exact midpoints between
    grid points (ties for half-to-even), the range's ends and beyond, +-0."""
    rng = np.random.default_rng(seed)
    res, top = 2.0 ** -fl, 2.0 ** (wl - fl - 1)
    k = rng.integers(-2 * 2 ** (wl - 1), 2 * 2 ** (wl - 1), size=256)
    special = [0.0, -0.0, top, -top, top - res, -top + res, 3 * top, -3 * top, 1e30, -1e30]
    x = np.concatenate([rng.normal(size=758) * top, (k + 0.5) * res, special])
    return x.astype(np.float32).reshape(8, 128)


def _pallas_fixed(x, wl, fl, symmetric, clamp):
    """``_fixed_kernel`` in interpret mode, with the bounds its wrapper
    computes (``ops/pallas/quant.py:75-77``)."""
    res = 2.0 ** (-fl)
    out = pl.pallas_call(
        functools.partial(_fixed_kernel, scale=2.0 ** fl,
                          t_min=-(2.0 ** (wl - fl - 1)) + (res if symmetric else 0.0),
                          t_max=(2.0 ** (wl - fl - 1)) - res, stochastic=False, clamp=clamp),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray([0], jnp.int32))
    return np.asarray(out)


@pytest.mark.parametrize("wl,fl", FORMATS)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("clamp", [True, False])
def test_fixed_point_nearest_matches_jax_and_the_pallas_kernel(wl, fl, symmetric, clamp):
    x = _fixed_inputs(wl, fl)
    got = fused_fixed_point_quantize(torch.from_numpy(x), wl, fl, clamp=clamp,
                                     symmetric=symmetric).numpy()
    want = np.asarray(jq.fixed_point_quantize(jnp.asarray(x), wl, fl, clamp=clamp,
                                              symmetric=symmetric))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pallas_fixed(x, wl, fl, symmetric, clamp))
    # The port's functional entry point is the same function.
    np.testing.assert_array_equal(
        tq.fixed_point_quantize(torch.from_numpy(x), wl, fl, clamp=clamp,
                                symmetric=symmetric).numpy(), got)


def test_fixed_point_format_bounds_match_jax():
    for wl, fl in FORMATS:
        for symmetric in (False, True):
            a, b = tq.FixedPoint(wl, fl, symmetric=symmetric), jq.FixedPoint(wl, fl,
                                                                               symmetric=symmetric)
            assert (a.t_min, a.t_max, a.resolution) == (b.t_min, b.t_max, b.resolution)
            clamped = tq.fixed_point_quantize(torch.tensor([-1e9, 1e9]), wl, fl,
                                              symmetric=symmetric)
            assert clamped.tolist() == [a.t_min, a.t_max]
    with pytest.raises(ValueError):
        tq.FixedPoint(0, 0)


def test_stochastic_uniform_follows_the_counter_layout():
    """u_i = (word i % 4 of Philox4x32-10((i // 4, 0, 0, 0), seed) >> 8) * 2^-24."""
    seed = torch.tensor([0x0123_4567_89AB_CDEF], dtype=torch.int64)
    n = 11
    u = stochastic_uniform(seed, n)
    assert u.dtype == torch.float32 and u.shape == (n,)
    for i in (0, 3, 4, 10):
        c = torch.tensor(i // 4)
        z = torch.tensor(0)
        word = philox4x32_10(c, z, z, z, torch.tensor(0x89AB_CDEF), torch.tensor(0x0123_4567))
        assert u[i].item() == (word[i % 4].item() >> 8) * 2.0 ** -24
    assert ((u >= 0) & (u < 1)).all()
    assert not torch.equal(u, stochastic_uniform(seed + 1, n))


@pytest.mark.parametrize("wl,fl", [(8, 4), (2, -2), (5, 7)])
def test_fixed_point_stochastic_statistics(wl, fl):
    """Each output is floor or ceil of x on the grid (clamped); the mean of
    many draws of one value is that value within 4 sigma; and the plain
    version is floor(x * 2^fl + u) / 2^fl with the kernel's u."""
    res, top = 2.0 ** -fl, 2.0 ** (wl - fl - 1)
    values = np.float32([0.3, -0.7, 0.1, -0.45]) * top
    n = 40000
    x = torch.from_numpy(np.repeat(values, n))
    gen = torch.Generator().manual_seed(5)
    q = tq.fixed_point_quantize(x, wl, fl, rounding="stochastic", generator=gen)
    lo = torch.floor(x / res) * res
    assert ((q == lo) | (q == lo + res) | (q == top - res)).all()
    for j, v in enumerate(values):
        qj = q[j * n:(j + 1) * n].double()
        frac = float(v) / res - np.floor(float(v) / res)
        sigma = res * np.sqrt(frac * (1 - frac) / n)
        assert abs(qj.mean().item() - float(v)) <= 4 * sigma + 1e-12
    seed = torch.tensor([17], dtype=torch.int64)
    got = fused_fixed_point_quantize(x, wl, fl, stochastic=True, seed=seed)
    u = stochastic_uniform(seed, x.numel())
    want = torch.clamp(torch.floor(x * 2.0 ** fl + u) / 2.0 ** fl, -top, top - res)
    assert torch.equal(got, want)
    # JAX's functional version draws other bits; its mean agrees all the same.
    jx = np.asarray(jq.fixed_point_quantize(jnp.asarray(x.numpy()), wl, fl,
                                            rounding="stochastic", key=jax.random.key(3)))
    for j, v in enumerate(values):
        frac = float(v) / res - np.floor(float(v) / res)
        sigma = res * np.sqrt(frac * (1 - frac) / n)
        assert abs(jx[j * n:(j + 1) * n].astype(np.float64).mean() - float(v)) <= 4 * sigma + 1e-12


def test_fixed_point_stochastic_draws_from_the_generator():
    x = torch.linspace(-3, 3, 1001)
    run = lambda s: tq.fixed_point_quantize(x, 8, 4, rounding="stochastic",
                                            generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        tq.fixed_point_quantize(x, 8, 4, rounding="stochastic")
    with pytest.raises(ValueError, match="rounding"):
        tq.fixed_point_quantize(x, 8, 4, rounding="proximal")
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize(x, 8, 4, stochastic=True)


def _codebooks():
    rng = np.random.default_rng(9)
    books = {f"lsq_fibbinary({n})": jq.lsq_fibbinary_codebook(n) for n in range(4, 12)}
    books["fibbinary(8, 4)"] = jq.fibbinary_codebook(8, 4)
    books["fibbinary(6, -1)"] = jq.fibbinary_codebook(6, -1)
    books["fibonacci(8, 4)"] = jq.fibonacci_sequence_codebook(8, 4)
    books["unsorted, repeated"] = np.concatenate([rng.permutation(
        jq.lsq_fibbinary_codebook(6)), [3.0, -1.0]])
    return books


CODEBOOKS = _codebooks()


def _codeword_inputs(cb, seed=1):
    """Values over the codebook's range and beyond, every codeword, every
    midpoint of two neighbours (a tie), +-0 and large values."""
    rng = np.random.default_rng(seed)
    s = np.unique(cb)
    lo, hi = s[0], s[-1]
    span = max(hi - lo, 1.0)
    x = np.concatenate([rng.uniform(lo - 0.2 * span, hi + 0.2 * span, size=700), s,
                        (s[1:] + s[:-1]) / 2, [0.0, -0.0, 1e30, -1e30]])
    return x.astype(np.float32)


def _pallas_codeword(x, cb):
    out = pl.pallas_call(
        functools.partial(_codeword_kernel, cb_size=cb.size),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(cb, jnp.float32))
    return np.asarray(out)


@pytest.mark.parametrize("name", list(CODEBOOKS))
def test_nearest_codeword_matches_jax_and_the_pallas_kernel(name):
    cb = CODEBOOKS[name]
    x = _codeword_inputs(cb)
    got = tq.nearest_codeword(torch.from_numpy(x), cb).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.nearest_codeword(jnp.asarray(x), cb)))
    np.testing.assert_array_equal(got, _pallas_codeword(x, cb))
    # Ties go to the lower-index codeword.
    ties = (cb[:-1] + cb[1:]) / 2
    first = [cb[np.argmin(np.abs(np.float32(t) - cb.astype(np.float32)))] for t in ties]
    assert tq.nearest_codeword(torch.tensor(ties, dtype=torch.float32), cb).tolist() == first


def test_nearest_codeword_plain_version_in_chunks(monkeypatch):
    """The plain version cut into many chunks gives the same answer."""
    from channelestimationtransformer_torch.ops.cuda import quant

    cb = torch.tensor(jq.lsq_fibbinary_codebook(8), dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(37, 29)).astype(np.float32)) * 90
    whole = nearest_codeword_reference(x, cb)
    monkeypatch.setattr(quant, "_PLAIN_CHUNK", 500)
    assert torch.equal(nearest_codeword_reference(x, cb), whole)
    assert torch.equal(fused_nearest_codeword(x, cb), whole) and whole.shape == x.shape


def test_codebooks_equal_jax():
    for m in range(1, 13):
        np.testing.assert_array_equal(tq.fibbinary_ints(m), jq.fibbinary_ints(m))
    for n in range(2, 13):
        np.testing.assert_array_equal(tq.lsq_fibbinary_codebook(n), jq.lsq_fibbinary_codebook(n))
    for wl, fl in [(8, 4), (6, -1), (10, 0), (4, 6)]:
        np.testing.assert_array_equal(tq.fibbinary_codebook(wl, fl), jq.fibbinary_codebook(wl, fl))
        np.testing.assert_array_equal(tq.fibonacci_sequence_codebook(wl, fl),
                                      jq.fibonacci_sequence_codebook(wl, fl))
    assert tq.lsq_fibbinary_codebook(8).size == 67 and tq.lsq_fibbinary_codebook(11).size == 287


@pytest.mark.parametrize("clamp", [True, False])
def test_codebook_quantizers_match_jax(clamp):
    x = np.random.default_rng(4).normal(size=(16, 40)).astype(np.float32) * 6
    for t_fn, j_fn in ((tq.fibonacci_quantize, jq.fibonacci_quantize),
                       (tq.no_adjacent_ones_quantize, jq.no_adjacent_ones_quantize)):
        np.testing.assert_array_equal(
            t_fn(torch.from_numpy(x), 6, 2, clamp=clamp).numpy(),
            np.asarray(j_fn(jnp.asarray(x), 6, 2, clamp=clamp)))


# --- PTQ ---------------------------------------------------------------------

def _flax_to_port_name(name):
    return name.replace("/", ".").removesuffix("kernel") + "weight"


@pytest.fixture(scope="module")
def small_pair():
    """Flax params of the small InformerStack (perturbed so that weights
    reach several grid points) and the port model loaded from them."""
    rng = np.random.default_rng(0)
    cfg = JaxInformerConfig(**SMALL)
    v = jax.jit(jax_build_informer(cfg).init)(
        jax.random.key(0), jnp.zeros((1, cfg.seq_len, 16)), jnp.zeros((1, cfg.dec_len, 16)))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
        np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    model = build_informer(InformerConfig(**SMALL), device="cpu")
    load_flax(model, params, stats)
    return cfg, params, stats, model


@pytest.mark.parametrize("wl", [4, 8, 12])
def test_ptq_weights_and_eval_match_jax(small_pair, wl):
    """The sweep's point (wl, fl = wl - 4), nearest: JAX's quantized params
    through from_flax equal the port's quantized state_dict exactly; the
    quantized models agree on a forward."""
    cfg, params, stats, model = small_pair
    fl = wl - 4
    jset = jq_settings.build_weight_quant_settings(
        params, lambda w, p, k: jq.fixed_point_quantize(w, wl, fl, rounding="nearest", key=k))
    jparams = jq.apply_weight_quant(params, jset, key=jax.random.key(wl))
    fp32 = {k: v.clone() for k, v in model.state_dict().items()}
    tset = tq.build_weight_quant_settings(
        model.state_dict(), lambda w, p, g: tq.fixed_point_quantize(w, wl, fl, rounding="nearest",
                                                                    generator=g))
    got = tq.apply_weight_quant(model.state_dict(), tset)
    want = from_flax(jax.tree.map(np.asarray, jparams), stats)
    assert sorted(tset.settings) == sorted(map(_flax_to_port_name, jset.settings))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # The FP32 tensors are left as they were.
    assert all(torch.equal(model.state_dict()[k], v) for k, v in fp32.items())

    qmodel = build_informer(InformerConfig(**SMALL), device="cpu")
    qmodel.load_state_dict(got)
    rng = np.random.default_rng(wl)
    x_enc = rng.normal(size=(3, cfg.seq_len, 16)).astype(np.float32)
    x_dec = rng.normal(size=(3, cfg.dec_len, 16)).astype(np.float32)
    flax_out = jax.jit(jax_build_informer(cfg).apply)(
        {"params": jparams, "batch_stats": stats}, jnp.asarray(x_enc), jnp.asarray(x_dec))
    with torch.no_grad():
        port_out = qmodel(torch.from_numpy(x_enc), torch.from_numpy(x_dec)).numpy()
    np.testing.assert_allclose(port_out, np.asarray(flax_out), rtol=2e-4, atol=2e-5)


def test_ptq_stochastic_draws_one_seed_per_tensor_in_name_order(small_pair):
    _, _, _, model = small_pair
    sd = model.state_dict()
    fn = lambda w, p, g: tq.fixed_point_quantize(w, 6, 2, rounding="stochastic", generator=g)
    settings = tq.build_weight_quant_settings(sd, fn)
    got = tq.apply_weight_quant(sd, settings, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    for name in sorted(settings.settings):  # the same draws, one tensor at a time
        assert torch.equal(got[name], fn(sd[name], 1.0, gen)), name
    other = tq.apply_weight_quant(sd, settings, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(got[name], other[name])
    untouched = [k for k in sd if k not in settings]
    assert untouched and all(got[k] is sd[k] for k in untouched)


def test_weight_quant_settings_validate_names(small_pair):
    sd = small_pair[3].state_dict()
    with pytest.raises(ValueError, match="unknown"):
        tq.WeightQuantSettings({"encoder.nope.weight": lambda w, p, g: w}, sd)
    with pytest.raises(ValueError, match="matched"):
        tq.build_weight_quant_settings(sd, lambda w, p, g: w, markers=("nothing",))
    names = tq.quantized_param_names(sd)
    assert "decoder.layer_0.self_attention.query.weight" in names
    assert "decoder.layer_0.cross_attention.out.weight" in names
    assert not any("distil" in n or "embedding" in n or "projection" in n for n in names)


def test_flagship_quantizes_the_same_72_tensors():
    """At InformerConfig() JAX's quantized_param_names (from the shapes of
    its params) and the port's give the same 72 tensors under the flax ->
    port name map, 52 of 128 x 128 and 20 of 128 x 64."""
    cfg = JaxInformerConfig()
    shapes = jax.eval_shape(jax_build_informer(cfg).init, jax.random.key(0),
                            jnp.zeros((1, cfg.seq_len, 16)), jnp.zeros((1, cfg.dec_len, 16)))
    jnames = jq_settings.quantized_param_names(shapes["params"])
    sd = build_informer(InformerConfig(), device="cpu").state_dict()
    names = tq.quantized_param_names(sd)
    assert len(names) == 72 and names == [_flax_to_port_name(n) for n in jnames]
    sizes = sorted(tuple(sd[n].shape) for n in names)
    assert sizes.count((128, 128)) == 52
    assert sizes.count((64, 128)) + sizes.count((128, 64)) == 20
    assert sum(sd[n].numel() for n in names) == 1_015_808
