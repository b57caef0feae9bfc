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
- Grouped fixed point (one launch over many tensors on the card): the
  grouped plain version equals JAX and ``_fixed_kernel`` in interpret mode
  exactly for nearest rounding, tensor by tensor, on a group with ragged,
  empty and offset tensors; stochastic tensor ``t`` draws Philox stream
  ``t`` (word 2 of the counter; stream 0 is the single-tensor layout),
  unbiased within 4 sigma; ``FixedPointWeightQuant`` through
  ``apply_weight_quant`` equals JAX's PTQ weights exactly and draws one
  seed per group.
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
from channelestimationtransformer_torch.ops.cuda.bd_attention import draw_seed
from channelestimationtransformer_torch.ops.cuda.quant import (
    fixed_point_quantize_grouped_reference,
    fixed_point_quantize_reference,
    fused_fixed_point_quantize,
    fused_fixed_point_quantize_grouped,
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


# --- grouped fixed point -------------------------------------------------------

def _group_arrays(wl, fl):
    """A group as the wrapper meets it: 1, 3 and 5 elements, 128 x 128, a
    ragged 1,003 (1,000,003 cut small), an empty tensor and a view that
    starts one element into its storage; values from ``_fixed_inputs``."""
    pool = np.concatenate([_fixed_inputs(wl, fl, seed=s).reshape(-1) for s in range(18)])
    cuts, arrays, at = [(1,), (3,), (5,), (128, 128), (1003,)], [], 0
    for shape in cuts:
        n = int(np.prod(shape))
        arrays.append(pool[at:at + n].reshape(shape))
        at += n
    return arrays + [np.zeros((0, 4), np.float32), pool[at:at + 301]]


def _group_tensors(arrays):
    tensors = [torch.from_numpy(a.copy()) for a in arrays[:-1]]
    base = torch.from_numpy(np.concatenate([[7.0], arrays[-1]]).astype(np.float32))
    return tensors + [base[1:]]  # offset view: storage_offset 1


@pytest.mark.parametrize("wl,fl", FORMATS)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("clamp", [True, False])
def test_grouped_nearest_matches_jax_and_the_pallas_kernel(wl, fl, symmetric, clamp):
    arrays = _group_arrays(wl, fl)
    tensors = _group_tensors(arrays)
    assert tensors[-1].storage_offset() == 1
    got = fused_fixed_point_quantize_grouped(tensors, wl, fl, clamp=clamp, symmetric=symmetric)
    assert len(got) == len(arrays)
    for a, x, q in zip(arrays, tensors, got):
        assert q.shape == x.shape and q.dtype == torch.float32
        if a.size == 0:
            continue
        want = np.asarray(jq.fixed_point_quantize(jnp.asarray(a), wl, fl, clamp=clamp,
                                                  symmetric=symmetric))
        np.testing.assert_array_equal(q.numpy(), want)
        np.testing.assert_array_equal(q.numpy(), _pallas_fixed(a, wl, fl, symmetric, clamp))
    # Stochastic settings without stochastic rounding read no seed, and the
    # single-tensor entry point is the group of one.
    assert all(torch.equal(fused_fixed_point_quantize(x, wl, fl, clamp=clamp,
                                                      symmetric=symmetric), q)
               for x, q in zip(tensors, got))


def _philox_py(counter, key):
    """Philox4x32-10 on Python ints: a third implementation, for known answers."""
    c, (k0, k1) = list(counter), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return c


def test_stochastic_uniform_streams_known_answers():
    """Random123's Philox4x32-10 known answers (the last with counter word 2
    set) hold for the Python-int generator, and u of stream t is word i % 4
    of counter (i // 4, 0, t, 0) shifted to 24 bits."""
    kat = [((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1])]
    for counter, key, want in kat:
        assert _philox_py(counter, key) == want
    seed = torch.tensor([0x299F_31D0_A409_3822], dtype=torch.int64)
    n = 13
    for stream in (0, 1, 0x13198A2E, 0xFFFFFFFF):
        u = stochastic_uniform(seed, n, stream)
        for i in range(n):
            word = _philox_py((i // 4, 0, stream, 0), (0xA4093822, 0x299F31D0))[i % 4]
            assert u[i].item() == (word >> 8) * 2.0 ** -24, (stream, i)
    assert torch.equal(stochastic_uniform(seed, n, 0), stochastic_uniform(seed, n))


@pytest.mark.parametrize("wl,fl", [(8, 4), (2, -2), (5, 7)])
def test_grouped_stochastic_draws_stream_t(wl, fl):
    """Tensor t is clamp(floor(x * 2^fl + u_t) / 2^fl) with u_t of stream t;
    t = 0 is the single-tensor result; the streams differ; and each
    tensor's mean error stays within 4 sigma."""
    res, top = 2.0 ** -fl, 2.0 ** (wl - fl - 1)
    values = np.float32([0.3, -0.7, 0.1, -0.45]) * top
    n = 20000
    tensors = [torch.full((n,), float(v)) for v in values]
    seed = torch.tensor([17], dtype=torch.int64)
    got = fused_fixed_point_quantize_grouped(tensors, wl, fl, stochastic=True, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(got, fixed_point_quantize_grouped_reference(
        tensors, wl, fl, stochastic=True, seed=seed)))
    for t, (x, q) in enumerate(zip(tensors, got)):
        u = stochastic_uniform(seed, n, stream=t)
        want = torch.clamp(torch.floor(x * 2.0 ** fl + u) / 2.0 ** fl, -top, top - res)
        assert torch.equal(q, want), t
        frac = float(values[t]) / res - np.floor(float(values[t]) / res)
        sigma = res * np.sqrt(frac * (1 - frac) / n)
        assert abs(q.double().mean().item() - float(values[t])) <= 4 * sigma + 1e-12, t
    assert torch.equal(got[0], fused_fixed_point_quantize(tensors[0], wl, fl, stochastic=True,
                                                          seed=seed))
    streams = [stochastic_uniform(seed, n, stream=t) for t in range(len(tensors))]
    assert all(not torch.equal(streams[a], streams[b]) for a in range(4) for b in range(a))


def test_grouped_wrapper_checks_its_inputs():
    x = torch.linspace(-3, 3, 64)
    assert fused_fixed_point_quantize_grouped([], 8, 4) == []
    with pytest.raises(ValueError, match="seed"):
        fused_fixed_point_quantize_grouped([x, x], 8, 4, stochastic=True)
    # Only a group wholly on the CPU takes the plain version.
    with pytest.raises(ValueError, match="one device"):
        fused_fixed_point_quantize_grouped([x, x.to("meta")], 8, 4)
    with pytest.raises(ValueError, match="meta"):
        fused_fixed_point_quantize_grouped([x.to("meta")], 8, 4)


def test_fixed_point_weight_quant_is_fixed_point_quantize():
    x = torch.from_numpy(_fixed_inputs(8, 4))
    for rounding in ("nearest", "stochastic"):
        fn = tq.FixedPointWeightQuant(8, 4, rounding, clamp=False, symmetric=True)
        want = tq.fixed_point_quantize(x, 8, 4, rounding=rounding, clamp=False, symmetric=True,
                                       generator=torch.Generator().manual_seed(2))
        assert torch.equal(fn(x, 1.0, torch.Generator().manual_seed(2)), want)
    assert tq.FixedPointWeightQuant(8, 4) == tq.FixedPointWeightQuant(8, 4, "nearest")
    assert tq.FixedPointWeightQuant(8, 4) != tq.FixedPointWeightQuant(8, 4, symmetric=True)
    with pytest.raises(ValueError, match="rounding"):
        tq.FixedPointWeightQuant(8, 4, "proximal")
    with pytest.raises(ValueError, match="Generator"):
        tq.FixedPointWeightQuant(8, 4, "stochastic").many([x])


@pytest.mark.parametrize("wl", [4, 8, 12])
def test_ptq_weights_through_the_grouped_quantizer_match_jax(small_pair, wl):
    """The sweep's point (wl, fl = wl - 4), nearest, through one
    FixedPointWeightQuant: exactly the tensors that from_flax makes of JAX's
    apply_weight_quant, and the caller's tensors left as they were."""
    _, params, stats, model = small_pair
    fl = wl - 4
    jset = jq_settings.build_weight_quant_settings(
        params, lambda w, p, k: jq.fixed_point_quantize(w, wl, fl, rounding="nearest", key=k))
    want = from_flax(jax.tree.map(np.asarray, jq.apply_weight_quant(
        params, jset, key=jax.random.key(wl))), stats)
    sd = model.state_dict()
    fp32 = {k: v.clone() for k, v in sd.items()}
    got = tq.apply_weight_quant(sd, tq.build_weight_quant_settings(
        sd, tq.FixedPointWeightQuant(wl, fl)))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(sd[k], v) for k, v in fp32.items())


def test_ptq_grouped_stochastic_draws_one_seed_per_group(small_pair):
    sd = small_pair[3].state_dict()
    fn = tq.FixedPointWeightQuant(6, 2, "stochastic")
    settings = tq.build_weight_quant_settings(sd, fn)
    gen = torch.Generator().manual_seed(3)
    got = tq.apply_weight_quant(sd, settings, generator=gen)
    by_hand = torch.Generator().manual_seed(3)
    seed = draw_seed(by_hand, "cpu")
    for t, name in enumerate(sorted(settings.settings)):
        want = fixed_point_quantize_reference(sd[name], 6, 2, stochastic=True, seed=seed,
                                              stream=t)
        assert torch.equal(got[name], want), name
    # One draw in all: the generators stand at the same place.
    assert torch.equal(draw_seed(gen, "cpu"), draw_seed(by_hand, "cpu"))
    other = tq.apply_weight_quant(sd, settings, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(got[name], other[name])
    untouched = [k for k in sd if k not in settings]
    assert untouched and all(got[k] is sd[k] for k in untouched)


def test_apply_weight_quant_mixes_closures_and_groups(small_pair, monkeypatch):
    """Closures go tensor by tensor, each distinct quantizer is one many()
    call over its names; for nearest rounding the result equals quantizing
    every tensor on its own."""
    sd = small_pair[3].state_dict()
    names = tq.quantized_param_names(sd)
    fmt = {0: (6, 2), 1: (8, 4), 2: (5, 1)}
    closure = lambda w, p, g: tq.fixed_point_quantize(w, 6, 2, generator=g)  # noqa: E731
    fns = {name: closure if i % 3 == 0 else tq.FixedPointWeightQuant(*fmt[i % 3])
           for i, name in enumerate(names)}
    calls = []
    many = tq.FixedPointWeightQuant.many
    monkeypatch.setattr(tq.FixedPointWeightQuant, "many",
                        lambda self, ts, g=None: calls.append(self) or many(self, ts, g))
    got = tq.apply_weight_quant(sd, tq.WeightQuantSettings(fns, sd))
    assert sorted(calls, key=lambda f: f.wl) == [tq.FixedPointWeightQuant(5, 1),
                                                 tq.FixedPointWeightQuant(8, 4)]
    for i, name in enumerate(names):
        want = fixed_point_quantize_reference(sd[name], *fmt[i % 3])
        assert torch.equal(got[name], want), name


def test_apply_weight_quant_stochastic_draw_order(small_pair):
    """Closures draw their seeds first, in name order; then each group draws
    one seed, its tensors on streams 0, 1, ... in name order."""
    sd = small_pair[3].state_dict()
    names = tq.quantized_param_names(sd)
    closure = lambda w, p, g: tq.fixed_point_quantize(  # noqa: E731
        w, 6, 2, rounding="stochastic", generator=g)
    quantizer = tq.FixedPointWeightQuant(8, 4, "stochastic")
    fns = {name: closure if i % 2 else quantizer for i, name in enumerate(names)}
    got = tq.apply_weight_quant(sd, tq.WeightQuantSettings(fns, sd),
                                generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    for name in names[1::2]:
        assert torch.equal(got[name], closure(sd[name], 1.0, gen)), name
    seed = draw_seed(gen, "cpu")
    for t, name in enumerate(names[0::2]):
        assert torch.equal(got[name], fixed_point_quantize_reference(
            sd[name], 8, 4, stochastic=True, seed=seed, stream=t)), name
