"""The link simulation in the port (``sim/``) against the JAX package's, on
the CPU, on the same numpy-seeded inputs.

- Exact: ``qam_constellation``, ``qam_map``, ``qam_demap_hard`` (a tie
  takes the first label), ``conv_encode``, ``make_qc_ldpc().proto``,
  ``_dense_adjacency``, ``ldpc_encode``, ``ldpc_syndrome``.
- Bit for bit on the same LLRs: ``viterbi_decode`` and ``ldpc_decode`` at
  the inputs of ``tests/test_coding_ofdm.py`` and ``tests/test_ldpc.py``
  (noiseless and AWGN), and at lower Eb/N0 where the decoders leave errors.
- Within 1e-5 of the reference's max |value|: ``qam_llr``, the OFDM
  functions, ``zf_precoder``, ``spectral_efficiency``,
  ``precoded_spectral_efficiency``, ``lmmse_equalize``.
- ``simulate_ber`` and ``simulate_coded_ber`` (conv and LDPC; perfect and
  LS CSI; frequency and time domain) given JAX's own draws, remade here with
  ``jax.random.split``, ``bernoulli`` and ``normal`` as ``sim/link.py``
  draws them: BER within 2 bits of the total, BLER equal, and the coded
  links' LLRs within 1e-5 of JAX's max. An LDPC frame that fails to decode
  in both is held by JAX's decoder on the port's LLRs instead (min-sum's
  last iterate there moves with the LLRs' last bits).
  The noise variance is JAX's float32 value bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.sim import coding as jc
from channelestimationtransformer_tpu.sim import estimation as je
from channelestimationtransformer_tpu.sim import ldpc as jl
from channelestimationtransformer_tpu.sim import link as jlink
from channelestimationtransformer_tpu.sim import ofdm as jo
from channelestimationtransformer_tpu.sim import precoding as jp
from channelestimationtransformer_tpu.sim import qam as jq

from channelestimationtransformer_torch import sim as tsim
from channelestimationtransformer_torch.sim import coding as tc
from channelestimationtransformer_torch.sim import estimation as te
from channelestimationtransformer_torch.sim import ldpc as tl
from channelestimationtransformer_torch.sim import link as tlink
from channelestimationtransformer_torch.sim import ofdm as to
from channelestimationtransformer_torch.sim import precoding as tp
from channelestimationtransformer_torch.sim import qam as tq

RTOL_MAX = 1e-5  # max |port - JAX| over max |JAX|
LAPACK_RTOL_MAX = 1e-4  # the batched 2 x 2 inverses, solves and determinants


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL_MAX):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_sim_exports_the_jax_names():
    import channelestimationtransformer_tpu.sim as jsim

    assert tsim.__all__ == jsim.__all__
    assert all(hasattr(tsim, name) for name in tsim.__all__)


# --- QAM ------------------------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 16, 64])
def test_qam_constellation_map_and_demap_equal_jax(order):
    rng = np.random.default_rng(order)
    const = tq.qam_constellation(order)
    assert const.dtype == torch.complex64
    np.testing.assert_array_equal(const.numpy(), np.asarray(jq.qam_constellation(order)))
    bps = int(np.log2(order))
    bits = rng.integers(0, 2, size=(3, 40 * bps)).astype(np.float32)
    syms = tq.qam_map(_t(bits), order)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jq.qam_map(jnp.asarray(bits), order)))
    y = syms.numpy() + 0.3 * _cplx(rng, *syms.shape)
    got = tq.qam_demap_hard(_t(y), order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.qam_demap_hard(jnp.asarray(y), order)))
    np.testing.assert_array_equal(tq.qam_demap_hard(syms, order).numpy(), bits)


def test_qam_demap_hard_takes_the_first_of_tied_symbols():
    """Points equidistant from two or four symbols (the origin, the axes
    between QPSK symbols, a 16-QAM midpoint) take the first label, as JAX's
    ``argmin``."""
    for order in (4, 16):
        const = np.asarray(jq.qam_constellation(order))
        ties = np.array([0.0, 1j * const[0].imag, const[0].real + 0j,
                         (const[0] + const[1]) / 2], np.complex64)
        got = tq.qam_demap_hard(_t(ties), order).numpy()
        np.testing.assert_array_equal(got, np.asarray(jq.qam_demap_hard(jnp.asarray(ties), order)))
    assert tq.qam_demap_hard(torch.zeros(1, dtype=torch.complex64), 4).tolist() == [0, 0]


@pytest.mark.parametrize("order, noise_var", [(4, 0.1), (16, 0.05), (4, 1.7)])
def test_qam_llr_matches_jax(order, noise_var):
    rng = np.random.default_rng(11)
    y = _cplx(rng, 5, 64)
    _close(tq.qam_llr(_t(y), order, noise_var),
           jq.qam_llr(jnp.asarray(y), order, noise_var))
    nv = np.float32(noise_var)
    _close(tq.qam_llr(_t(y), order, torch.tensor(nv)), jq.qam_llr(jnp.asarray(y), order, nv))


# --- OFDM -----------------------------------------------------------------------------


def test_ofdm_functions_match_jax():
    """The inputs of ``test_time_domain_equals_frequency_domain``: modulate,
    the tapped channel, demodulate and the taps' frequency response."""
    rng = np.random.default_rng(3)
    fft_size, cp_len, num_taps, num_sym = 64, 16, 9, 5
    x = _cplx(rng, 2, num_sym, fft_size)
    taps = (_cplx(rng, 2, num_taps) * (0.5 ** np.arange(num_taps))).astype(np.complex64)
    tx_j = jo.ofdm_modulate(jnp.asarray(x), cp_len)
    tx_t = to.ofdm_modulate(_t(x), cp_len)
    _close(tx_t, tx_j)
    _close(to.ofdm_modulate(_t(x), 0), jo.ofdm_modulate(jnp.asarray(x), 0))
    rx_j = jo.apply_time_channel(tx_j, jnp.asarray(taps))
    rx_t = to.apply_time_channel(_t(np.asarray(tx_j)), _t(taps))
    _close(rx_t, rx_j)
    _close(to.ofdm_demodulate(_t(np.asarray(rx_j)), fft_size, cp_len),
           jo.ofdm_demodulate(rx_j, fft_size, cp_len))
    _close(to.taps_to_frequency_response(_t(taps), fft_size),
           jo.taps_to_frequency_response(jnp.asarray(taps), fft_size))
    # The invariant of the reference's two branches, in the port.
    y = to.ofdm_demodulate(to.apply_time_channel(tx_t, _t(taps)), fft_size, cp_len)
    h = to.taps_to_frequency_response(_t(taps), fft_size)[:, None, :]
    np.testing.assert_allclose(y.numpy(), (h * _t(x)).numpy(), rtol=1e-4, atol=1e-4)


# --- precoding and estimation ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 2, 8), (16, 2, 4)])
def test_precoding_and_spectral_efficiency_match_jax(shape):
    rng = np.random.default_rng(2)
    h = _cplx(rng, *shape)
    h_est = (h + 0.3 * _cplx(rng, *shape)).astype(np.complex64)
    _close(tp.zf_precoder(_t(h)), jp.zf_precoder(jnp.asarray(h)))
    ri = np.stack([h.real, h.imag], axis=-1)
    _close(tp.zf_precoder(_t(ri)), jp.zf_precoder(jnp.asarray(ri)))
    for snr in (1.0, 100.0):
        _close(tp.spectral_efficiency(_t(h), snr), jp.spectral_efficiency(jnp.asarray(h), snr))
        _close(tp.precoded_spectral_efficiency(_t(h), _t(h_est), snr),
               jp.precoded_spectral_efficiency(jnp.asarray(h), jnp.asarray(h_est), snr))
    with pytest.raises(ValueError, match="real-pair"):
        tp.zf_precoder(torch.zeros(2, 2, 3))


def test_ls_and_lmmse_match_jax():
    rng = np.random.default_rng(9)
    y, h = _cplx(rng, 6, 32, 2), _cplx(rng, 6, 32, 2, 2)
    for nv in (np.float32(0.05), np.float32(1.3)):
        want = jax.vmap(jax.vmap(lambda yy, hh: je.lmmse_equalize(yy, hh, nv)))(
            jnp.asarray(y), jnp.asarray(h))
        _close(te.lmmse_equalize(_t(y), _t(h), torch.tensor(nv)), want)
    x = (_cplx(rng, 4) + 2).astype(np.complex64)
    _close(te.ls_estimate(_t(y[0, :4, 0]), _t(x)),
           je.ls_estimate(jnp.asarray(y[0, :4, 0]), jnp.asarray(x)))


# --- convolutional code ---------------------------------------------------------------


def test_conv_encode_equals_jax():
    rng = np.random.default_rng(0)
    for bits in (rng.integers(0, 2, 40), rng.integers(0, 2, (3, 5, 64))):
        got = tc.conv_encode(_t(bits))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jc.conv_encode(jnp.asarray(bits))))
    np.testing.assert_array_equal(tc._OUT, jc._OUT)
    np.testing.assert_array_equal(tc._NEXT_STATE, jc._NEXT_STATE)
    assert tc.coded_rate() == jc.coded_rate()


def _viterbi_inputs():
    """The noiseless and AWGN inputs of ``tests/test_coding_ofdm.py``, and
    the AWGN input at 1 dB and -1 dB, where the decoder leaves errors."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (3, 64))
    cases = [((1.0 - 2.0 * np.asarray(jc.conv_encode(jnp.asarray(bits)))) * 4.0)
             .astype(np.float32)]
    for ebno_db in (4.0, 1.0, -1.0):
        rng = np.random.default_rng(2)
        bits = rng.integers(0, 2, (16, 256))
        x = 1.0 - 2.0 * np.asarray(jc.conv_encode(jnp.asarray(bits)), np.float32)
        sigma2 = 1.0 / (2 * 0.5 * 10 ** (ebno_db / 10))
        y = x + (rng.normal(size=x.shape) * np.sqrt(sigma2)).astype(np.float32)
        cases.append((2.0 * y / sigma2).astype(np.float32))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_viterbi_decode_equals_jax_bit_for_bit(case):
    llr = _viterbi_inputs()[case]
    n = llr.shape[-1] // 2 - (tc.K - 1)
    got = tc.viterbi_decode(_t(llr), num_bits=n)
    assert got.dtype == torch.int32 and got.shape == (llr.shape[0], n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.viterbi_decode(jnp.asarray(llr), n)))


def test_viterbi_ties_take_decision_zero():
    """All-zero LLRs tie every compare: JAX and the port both keep decision
    0 everywhere, and leading axes fold as JAX's."""
    llr = np.zeros((2, 3, 2 * (10 + tc.K - 1)), np.float32)
    got = tc.viterbi_decode(_t(llr), num_bits=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.viterbi_decode(jnp.asarray(llr), 10)))


# --- QC-LDPC --------------------------------------------------------------------------

CODE_J = jl.make_qc_ldpc(z=27, kb=12, mb=12, seed=0)
CODE_T = tl.make_qc_ldpc(z=27, kb=12, mb=12, seed=0)


@pytest.mark.parametrize("kwargs", [{}, dict(seed=3), dict(z=9, kb=6, mb=4, row_weight=3)])
def test_ldpc_prototype_and_adjacency_equal_jax(kwargs):
    cj, ct = jl.make_qc_ldpc(**kwargs), tl.make_qc_ldpc(**kwargs)
    assert ct.proto == cj.proto and (ct.n, ct.k, ct.z) == (cj.n, cj.k, cj.z)
    for got, want in zip(tl._dense_adjacency(ct), jl._dense_adjacency(cj)):
        np.testing.assert_array_equal(got, want)


def test_ldpc_encode_and_syndrome_equal_jax():
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (2, 4, CODE_J.k)).astype(np.int32)
    cw = tl.ldpc_encode(CODE_T, _t(info))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jl.ldpc_encode(CODE_J, jnp.asarray(info))))
    assert int(tl.ldpc_syndrome(CODE_T, cw).sum()) == 0
    bad = cw.clone()
    bad[..., ::50] ^= 1
    np.testing.assert_array_equal(tl.ldpc_syndrome(CODE_T, bad).numpy(),
                                  np.asarray(jl.ldpc_syndrome(CODE_J, jnp.asarray(bad.numpy()))))


def _ldpc_inputs():
    """``tests/test_ldpc.py``'s noiseless (10 iterations) and 3 dB AWGN (30)
    inputs, and 1 dB, where the decoder leaves errors."""
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (4, CODE_J.k)).astype(np.int32)
    cw = np.asarray(jl.ldpc_encode(CODE_J, jnp.asarray(info)))
    cases = [((1.0 - 2.0 * cw).astype(np.float32) * 6.0, 10)]
    for ebno_db in (3.0, 1.0):
        rng = np.random.default_rng(2)
        info = rng.integers(0, 2, (24, CODE_J.k)).astype(np.int32)
        x = 1.0 - 2.0 * np.asarray(jl.ldpc_encode(CODE_J, jnp.asarray(info)), np.float32)
        sigma2 = 1.0 / (2 * 0.5 * 10 ** (ebno_db / 10))
        y = x + rng.normal(size=x.shape) * np.sqrt(sigma2)
        cases.append(((2.0 * y / sigma2).astype(np.float32), 30))
    return cases


@pytest.mark.parametrize("case", range(3))
def test_ldpc_decode_equals_jax_bit_for_bit(case):
    llr, iters = _ldpc_inputs()[case]
    got = tl.ldpc_decode(CODE_T, _t(llr), num_iters=iters)
    assert got.dtype == torch.int32 and got.shape == (llr.shape[0], CODE_J.k)
    want = np.asarray(jl.ldpc_decode(CODE_J, jnp.asarray(llr), num_iters=iters))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the link, given JAX's draws ------------------------------------------------------


def _jax_draws(key, shape_bits, bits_dtype, noise_shape):
    """``sim/link.py``'s draws from ``key``: the payload, then the unit complex
    noise of the received shape."""
    k_bits, k_noise = jax.random.split(key)
    bits = np.asarray(jax.random.bernoulli(k_bits, 0.5, shape_bits).astype(bits_dtype))
    kr, ki = jax.random.split(k_noise)
    noise = (np.asarray(jax.random.normal(kr, noise_shape))
             + 1j * np.asarray(jax.random.normal(ki, noise_shape))).astype(np.complex64)
    return bits, noise


def _noise_shape(b, n_rx, num_symbols, csi, domain, n_streams=2):
    f = num_symbols if domain == "freq" else num_symbols + max(num_symbols // 4, 1)
    return (b, n_rx, 1 + (n_streams if csi == "ls" else 0), f)


def _channels(seed, b=16):
    rng = np.random.default_rng(seed)
    h = (_cplx(rng, b, 2, 4) / np.sqrt(2)).astype(np.complex64)
    h_pre = (h + 0.2 * _cplx(rng, b, 2, 4)).astype(np.complex64)
    return h, h_pre


@pytest.mark.parametrize("ebno", [-4.0, -2.0, 2.0, 10.0])
@pytest.mark.parametrize("bps, rate", [(2, 1.0), (2, 0.5), (4, 1.0), (4, 0.5)])
def test_noise_var_equals_jax_jitted(bps, rate, ebno):
    """JAX's ``esno``/``noise_var`` under ``jax.jit`` (``link.py:188-189,
    276-277``), bit for bit."""
    if rate == 1.0:
        want = jax.jit(lambda e: 1.0 / (10.0 ** (jnp.asarray(e) / 10.0) * bps))(ebno)
    else:
        want = jax.jit(lambda e: 1.0 / (10.0 ** (jnp.asarray(e) / 10.0) * bps * 0.5))(ebno)
    got = tlink._noise_var(ebno, bps, rate, "cpu")
    assert got.dtype == torch.float32 and got.item() == np.asarray(want).item()


UNCODED = [("perfect", "freq"), ("ls", "freq"), ("perfect", "time"), ("ls", "time")]


@pytest.mark.parametrize("csi, domain", UNCODED)
def test_simulate_ber_with_jax_draws(csi, domain):
    h, h_pre = _channels(4)
    key, ebno, n_sym = jax.random.key(5), 2.0, 64
    bits, noise = _jax_draws(key, (16, 2 * n_sym * 2), jnp.float32,
                             _noise_shape(16, 2, n_sym, csi, domain))
    ber_j, total_j = jlink.simulate_ber(key, jnp.asarray(h), jnp.asarray(h_pre), ebno,
                                        jlink.LinkConfig(), n_sym, csi=csi, domain=domain)
    ber_t, total_t = tlink.simulate_ber(None, _t(h), _t(h_pre), ebno, tlink.LinkConfig(),
                                        n_sym, csi, domain, bits=_t(bits), noise=_t(noise),
                                        device="cpu")
    assert total_t == int(total_j)
    assert ber_t.dtype == torch.float32
    assert abs(float(ber_t) - float(ber_j)) * total_t <= 2, (float(ber_t), float(ber_j))
    assert 0.0 < float(ber_j) < 0.5


CODED = [("conv", "perfect", "freq"), ("conv", "ls", "time"),
         ("ldpc", "perfect", "time"), ("ldpc", "ls", "freq")]


def _jax_llrs(monkeypatch, fec, *args, **kwargs):
    """The LLRs JAX's ``simulate_coded_ber`` hands its decoder, read by a spy
    in its place (the body run eagerly, so the spy sees values)."""
    seen = {}

    def viterbi(llr, num_bits):
        seen["llr"] = np.asarray(llr)
        return jnp.zeros((llr.shape[0], num_bits), jnp.int32)

    def ldpc(code, llr, num_iters=25, alpha=0.75):
        seen["llr"] = np.asarray(llr)
        return jnp.zeros((*llr.shape[:-1], code.k), jnp.int32)

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jc, "viterbi_decode", viterbi)
        m.setattr(jl, "ldpc_decode", ldpc)
        jlink.simulate_coded_ber(*args, fec=fec, **kwargs)
    return seen["llr"]


@pytest.mark.parametrize("fec, csi, domain", CODED)
def test_simulate_coded_ber_with_jax_draws(fec, csi, domain, monkeypatch):
    """The decoder's LLRs within 1e-5 of JAX's max, BLER equal and BER
    within 2 bits of the total. In an LDPC frame that fails to decode,
    min-sum has not converged and its last iterate moves with the LLRs' last
    bits (LAPACK's solve against XLA's, two FFT libraries), so there the
    limit on the bits is the frame's own: JAX's jitted decoder on the port's
    LLRs gives the port's bits, and the two BERs differ by at most the bits
    of the frames both fail."""
    h, h_pre = _channels(6)
    key, ebno = jax.random.key(5), 1.0
    n_sym = 162 if fec == "ldpc" else 64
    info_shape = (16, 1, CODE_J.k) if fec == "ldpc" else (16, n_sym * 2 * 2 // 2 - 6)
    info, noise = _jax_draws(key, info_shape, jnp.int32,
                             _noise_shape(16, 2, n_sym, csi, domain))
    args = (key, jnp.asarray(h), jnp.asarray(h_pre), ebno, jlink.LinkConfig(), n_sym)
    ber_j, bler_j, total_j = jlink.simulate_coded_ber(*args, fec=fec, csi=csi, domain=domain)
    llr_j = _jax_llrs(monkeypatch, fec, *args, csi=csi, domain=domain)
    seen = {}

    def viterbi_spy(llr, num_bits):
        seen["llr"], seen["bits"] = llr, tc.viterbi_decode(llr, num_bits)
        return seen["bits"]

    def ldpc_spy(code, llr, num_iters=25, alpha=0.75):
        seen["llr"], seen["bits"] = llr, tl.ldpc_decode(code, llr, num_iters, alpha)
        return seen["bits"]

    monkeypatch.setattr(tlink, "viterbi_decode", viterbi_spy)
    monkeypatch.setattr(tlink, "ldpc_decode", ldpc_spy)
    ber_t, bler_t, total_t = tlink.simulate_coded_ber(
        None, _t(h), _t(h_pre), ebno, tlink.LinkConfig(), n_sym, fec, csi, domain,
        info=_t(info), noise=_t(noise), device="cpu")
    _close(seen["llr"].numpy(), llr_j)
    assert total_t == int(total_j)
    assert float(bler_t) == float(bler_j) and 0.0 < float(bler_j)
    diff_bits = abs(float(ber_t) - float(ber_j)) * total_t
    if fec == "conv":
        assert diff_bits <= 2, (float(ber_t), float(ber_j))
        return
    want = np.asarray(jl.ldpc_decode(CODE_J, jnp.asarray(seen["llr"].numpy()), num_iters=25))
    np.testing.assert_array_equal(seen["bits"].numpy(), want)
    failed = float(bler_t) * 16
    assert diff_bits <= 2 + failed * CODE_J.k, (float(ber_t), float(ber_j))


def test_link_draws_from_the_generator_and_rejects_bad_inputs():
    """Without injected draws the port draws from the generator (same seed,
    same result); an LDPC payload that is no multiple of 648, an unknown CSI
    or domain raise as in JAX."""
    h, h_pre = _channels(8, b=4)
    runs = [tlink.simulate_coded_ber(torch.Generator().manual_seed(3), _t(h), _t(h_pre), 0.0,
                                     num_symbols=64, device="cpu") for _ in range(2)]
    assert [float(r[0]) for r in runs[:1]] == [float(r[0]) for r in runs[1:]]
    with pytest.raises(ValueError, match="multiple of"):
        tlink.simulate_coded_ber(None, _t(h), _t(h), 6.0, num_symbols=100, fec="ldpc",
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown csi"):
        tlink.simulate_ber(torch.Generator(), _t(h), _t(h), 6.0, csi="mmse", device="cpu")
    with pytest.raises(ValueError, match="unknown domain"):
        tlink.simulate_ber(torch.Generator(), _t(h), _t(h), 6.0, domain="delay", device="cpu")


def test_pilot_symbols_follow_jax_double_swapaxes():
    p = np.arange(2 * 4 * 2, dtype=np.float32).reshape(2, 4, 2)
    got = tlink._pilot_symbols(_t(p), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlink._pilot_symbols(jnp.asarray(p), 2)))
    assert got.shape == (2, 4, 2, 1) and got[1, 3, 0, 0] == p[1, 3, 0]
