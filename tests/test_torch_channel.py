"""The port's channel generator and data packing against the JAX package's.

Where JAX draws its own randomness, the test rebuilds JAX's draws from the
same key exactly as the JAX function does (``channel/cdl.py:258-312``:
the key split in four, the vmapped permutations, the phases and the UE
direction; ``channel/dataset.py:202``: one split per chunk) and injects
them into the port. Tolerances, each named where it is used:

- packing: atol 1e-6 (float32 rounding);
- ``pack_features`` and ``from_pickle``: bit for bit;
- the CDL channel from JAX's draws: max|diff| <= 1e-4 on the unit-energy
  channel (XLA turns the divisions by constants into products by the
  reciprocal and fuses multiply-adds, so the ray phases, up to ~120 rad at
  40 slots, where one float32 ulp is 7.6e-6, differ in their last bits);
- the beam sweep: ``selected`` equal, ``h_eff`` within 1e-4;
- ``standardize_time_series`` atol 1e-5; interpolation atol 1e-5;
- the port's own draws: unit energy per sample at rtol 1e-4.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.channel import beamforming as jbf
from channelestimationtransformer_tpu.channel import cdl as jcdl
from channelestimationtransformer_tpu.channel import dataset as jds
from channelestimationtransformer_tpu.channel import interpolate as jinterp
from channelestimationtransformer_tpu.data import packing as jpack
from channelestimationtransformer_tpu.data.windows import WindowDataset as JaxWindowDataset
from channelestimationtransformer_tpu.data.windows import pack_features as jax_pack_features
from channelestimationtransformer_tpu.parallel.mesh import make_mesh as jax_make_mesh

from channelestimationtransformer_torch.channel import beamforming as bf
from channelestimationtransformer_torch.channel import cdl
from channelestimationtransformer_torch.channel import dataset as ds
from channelestimationtransformer_torch.channel import interpolate
from channelestimationtransformer_torch.data import packing
from channelestimationtransformer_torch.data.windows import WindowDataset, pack_features

from torch_parallel_worker import spawn

CHANNEL_TOL = 1e-4

# (port model, JAX model) pairs at the widths the tests use.
MODELS = {
    "default": (cdl.CDLModel(), jcdl.CDLModel()),
    "default_16x2": (cdl.CDLModel(num_bs_ant=16), jcdl.CDLModel(num_bs_ant=16)),
    "calibrated_5": (cdl.CDLModel.calibrated(5.0), jcdl.CDLModel.calibrated(5.0)),
    "no_pattern_16x2": (cdl.CDLModel(num_bs_ant=16, bs_pattern_38901=False),
                        jcdl.CDLModel(num_bs_ant=16, bs_pattern_38901=False)),
}


def jax_cdl_draws(key, model, batch_size) -> cdl.CDLDraws:
    """The draws JAX's ``generate_cdl_channel`` makes from ``key``."""
    n, m = len(model.table.delays), model.num_rays
    k_phase, k_coup_a, k_coup_z, k_vel = jax.random.split(key, 4)

    def perm(k):
        return jax.vmap(lambda kb: jax.vmap(lambda kk: jax.random.permutation(kk, m))(
            jax.random.split(kb, n)))(jax.random.split(k, batch_size))

    return cdl.CDLDraws(
        perm_a=torch.from_numpy(np.array(perm(k_coup_a))).long(),
        perm_z=torch.from_numpy(np.array(perm(k_coup_z))).long(),
        phases=torch.from_numpy(np.array(jax.random.uniform(
            k_phase, (batch_size, n, m), minval=-jnp.pi, maxval=jnp.pi))),
        vel_az=torch.from_numpy(np.array(jax.random.uniform(
            k_vel, (batch_size,), minval=0.0, maxval=2 * jnp.pi))),
    )


def jax_chunk_keys(key, num_samples, batch_size):
    """JAX's ``generate_beamformed_dataset`` chunk keys and sizes."""
    out = []
    for start in range(0, num_samples, batch_size):
        key, sub = jax.random.split(key)
        out.append((sub, min(batch_size, num_samples - start)))
    return out


def _rng_arrays(shape, seed=0):
    rng = np.random.default_rng(seed)
    re, im = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    return re, im


# --- data/packing.py ------------------------------------------------------


def _packing_cases():
    re, im = _rng_arrays((3, 7, 2, 4))
    hc = (re + 1j * im).astype(np.complex64)
    ri = np.stack([re, im], axis=-1)
    feats = ri.reshape(3, 7, 16)
    return {
        "to_ri": ((hc,), {}),
        "from_ri": ((ri,), {}),
        "ri_abs2": ((ri,), {}),
        "ri_channel_norm": ((ri,), {}),
        "ri_channel_norm_axis": ((ri,), {"axis": (-3, -2, -1)}),
        "ri_pack": ((ri,), {}),
        "complex_to_real": ((hc,), {}),
        "real_to_complex": ((feats,), {}),
        "channel_norm": ((hc,), {}),
        "channel_norm_axis": ((hc,), {"axis": (-3, -2, -1)}),
    }


@pytest.mark.parametrize("case", sorted(_packing_cases()))
def test_packing_matches_jax(case):
    args, kwargs = _packing_cases()[case]
    name = case.removesuffix("_axis")
    want = np.asarray(getattr(jpack, name)(*map(jnp.asarray, args), **kwargs))
    got = getattr(packing, name)(*map(torch.from_numpy, args), **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis", [None, (-3, -2, -1)])
def test_awgn_with_jax_noise_matches_jax(axis):
    """``awgn`` and ``ri_awgn`` fed the normals JAX draws from the same key
    (``awgn`` splits it for the real and imaginary parts)."""
    re, im = _rng_arrays((3, 7, 2, 4), seed=1)
    hc = (re + 1j * im).astype(np.complex64)
    ri = np.stack([re, im], axis=-1)
    key = jax.random.key(5)
    kr, ki = jax.random.split(key)
    noise = (np.asarray(jax.random.normal(kr, hc.shape))
             + 1j * np.asarray(jax.random.normal(ki, hc.shape))).astype(np.complex64)
    want = np.asarray(jpack.awgn(key, jnp.asarray(hc), 10.0, axis=axis))
    got = packing.awgn(None, torch.from_numpy(hc), 10.0, axis=axis,
                       noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ri_noise = np.array(jax.random.normal(key, ri.shape))
    want = np.asarray(jpack.ri_awgn(key, jnp.asarray(ri), 10.0, axis=axis))
    got = packing.ri_awgn(None, torch.from_numpy(ri), 10.0, axis=axis,
                          noise=torch.from_numpy(ri_noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_awgn_draws_from_the_generator_at_the_snr():
    h = torch.ones(64, 64, dtype=torch.complex64)
    a = packing.awgn(torch.Generator().manual_seed(0), h, 10.0)
    b = packing.awgn(torch.Generator().manual_seed(0), h, 10.0)
    assert torch.equal(a, b)
    # noise power sigma = 10^-1 relative to |h|^2 = 1: re and im get 0.05 each
    noise = a - h
    assert abs(noise.real.var().item() - 0.05) < 0.005
    assert abs(noise.imag.var().item() - 0.05) < 0.005
    x = torch.ones(64, 64, 2)
    assert abs((packing.ri_awgn(torch.Generator().manual_seed(0), x, 10.0) - x).var().item()
               - 0.1) < 0.01


# --- data/windows.py: pack_features and from_pickle ------------------------


def test_pack_features_and_from_pickle_match_jax_bit_for_bit(tmp_path):
    re, im = _rng_arrays((5, 30, 2, 4), seed=2)
    ri = np.stack([re, im], axis=-1)
    np.testing.assert_array_equal(pack_features(torch.from_numpy(ri)).numpy(),
                                  np.asarray(jax_pack_features(jnp.asarray(ri))))
    path = tmp_path / "ds.pickle"
    with open(path, "wb") as f:
        pickle.dump((re + 1j * im).astype(np.complex64), f)
    got = WindowDataset.from_pickle(str(path), seq_len=20, pred_len=5, snr_db=12.0,
                                    device="cpu")
    want = JaxWindowDataset.from_pickle(str(path), seq_len=20, pred_len=5, snr_db=12.0)
    assert got.h.dtype == torch.float32 and got.h.device.type == "cpu"
    np.testing.assert_array_equal(got.h.numpy(), np.asarray(want.h))
    assert (got.seq_len, got.pred_len, got.snr_db) == (want.seq_len, want.pred_len, want.snr_db)


# --- channel/cdl.py ------------------------------------------------------


def test_tables_are_the_jax_packages():
    np.testing.assert_array_equal(cdl.RAY_OFFSETS, jcdl.RAY_OFFSETS)
    for field in ("delays", "powers_db", "aod", "aoa", "zod", "zoa"):
        np.testing.assert_array_equal(getattr(cdl.CDL_B, field), getattr(jcdl.CDL_B, field))
    for field in ("name", "c_asd", "c_asa", "c_zsd", "c_zsa"):
        assert getattr(cdl.CDL_B, field) == getattr(jcdl.CDL_B, field)
    for port, ref in MODELS.values():
        assert (port.wavelength, port.sampling_frequency, port.ue_speed_ms) == (
            ref.wavelength, ref.sampling_frequency, ref.ue_speed_ms)


@pytest.mark.parametrize("argv", [[], ["--calibrated"], ["--calibrated", "--ue-speed-kmh", "5"],
                                  ["--ue-speed-kmh", "5", "--slot-symbols", "14"]])
def test_channel_args_give_the_jax_packages_model(argv):
    import argparse

    models = []
    for module in (cdl, jcdl):
        parser = argparse.ArgumentParser()
        module.add_channel_args(parser)
        models.append(module.cdl_from_args(parser.parse_args(argv)))
    port, ref = models
    for field in ("carrier_frequency", "num_bs_ant", "num_ut_ant", "ue_speed_ms",
                  "sampling_frequency", "num_rays", "bs_pattern_38901"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("name,batch,slots", [
    ("default", 4, 40), ("default_16x2", 6, 10), ("calibrated_5", 4, 40),
    ("no_pattern_16x2", 6, 20)])
def test_cdl_channel_from_jax_draws_matches_jax(name, batch, slots):
    port, ref = MODELS[name]
    key = jax.random.key(11)
    want = np.asarray(jcdl.generate_cdl_channel(key, ref, batch, slots))
    got = cdl.generate_cdl_channel(port, batch, slots, device="cpu",
                                   draws=jax_cdl_draws(key, ref, batch))
    assert got.shape == want.shape == (batch, slots, port.num_ut_ant, port.num_bs_ant, 2)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= CHANNEL_TOL, err


def test_cdl_channel_needs_a_generator_or_draws():
    with pytest.raises(ValueError, match="Generator"):
        cdl.generate_cdl_channel(cdl.CDLModel(), 2, 10, device="cpu")
    draws = cdl.CDLDraws.sample(cdl.CDLModel(), 3, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="draws"):
        cdl.generate_cdl_channel(cdl.CDLModel(), 2, 10, device="cpu", draws=draws)


def test_cdl_draws_are_permutations_in_range():
    model = cdl.CDLModel()
    d = cdl.CDLDraws.sample(model, 8, torch.Generator().manual_seed(0), "cpu")
    ref = torch.arange(model.num_rays).expand(8, 23, -1)
    assert torch.equal(d.perm_a.sort(-1).values, ref)
    assert torch.equal(d.perm_z.sort(-1).values, ref)
    assert not torch.equal(d.perm_a, d.perm_z)
    assert d.phases.dtype == torch.float32 and d.phases.shape == (8, 23, 20)
    assert d.phases.min() >= -np.pi and d.phases.max() <= np.pi
    assert d.vel_az.min() >= 0 and d.vel_az.max() <= 2 * np.pi


def _to_c(x):
    x = np.asarray(x)
    return x[..., 0] + 1j * x[..., 1]


def test_port_draws_unit_energy_and_reproducible():
    model = cdl.CDLModel(num_bs_ant=16)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = cdl.generate_cdl_channel(model, 4, 30, device="cpu", generator=gen(0))
    b = cdl.generate_cdl_channel(model, 4, 30, device="cpu", generator=gen(0))
    c = cdl.generate_cdl_channel(model, 4, 30, device="cpu", generator=gen(1))
    assert a.shape == (4, 30, 2, 16, 2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    hc = _to_c(a)
    for i in range(4):
        np.testing.assert_allclose(np.mean(np.abs(hc[i]) ** 2), 1.0, rtol=1e-4)


def test_port_draws_correlation_tracks_doppler():
    """As ``tests/test_channel.py:48-62`` asserts for JAX: a slower UE gives
    a higher slot-to-slot correlation (28 GHz, 1.6 kHz slots)."""
    def corr(speed_ms):
        m = cdl.CDLModel(num_bs_ant=8, num_ut_ant=1, ue_speed_ms=speed_ms)
        h = cdl.generate_cdl_channel(m, 32, 50, device="cpu",
                                     generator=torch.Generator().manual_seed(1))
        x = _to_c(h).reshape(32, 50, -1)
        num = np.abs(np.mean(np.sum(x[:, 1:] * np.conj(x[:, :-1]), axis=-1)))
        den = np.mean(np.sum(np.abs(x) ** 2, axis=-1))
        return num / den

    c_slow, c_fast = corr(1.0), corr(30.0)
    assert c_slow > 0.95, c_slow
    assert c_fast < c_slow - 0.3, (c_slow, c_fast)


def _lag_curve(x, lags=(1, 2, 3, 5, 10)):
    """``experiments/calibrate_channel.py:lag_curve`` on complex [N, T, F]."""
    xm = x - x.mean(axis=1, keepdims=True)
    out = {}
    for k in lags:
        a, b = xm[:, :-k].reshape(-1), xm[:, k:].reshape(-1)
        out[k] = float(np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


def test_port_data_lag_curve_matches_jax_statistically():
    """The parity recipe's channel (calibrated, 5 km/h): the port's own draws
    and JAX's give the same lag correlation curve, within what 256 samples
    of 100 slots can resolve (the tolerance grows with the lag, as the
    curve's spread between seeds does)."""
    def curve(h):
        x = _to_c(h).reshape(h.shape[0], h.shape[1], -1)
        return _lag_curve(x / np.sqrt(np.mean(np.abs(x) ** 2, axis=(1, 2), keepdims=True)))

    port, ref = MODELS["calibrated_5"]
    want = curve(np.asarray(jds.generate_beamformed_dataset(
        jax.random.key(0), model=ref, num_samples=256, num_slots=100)))
    got = curve(ds.generate_beamformed_dataset(0, model=port, num_samples=256, num_slots=100,
                                               device="cpu").numpy())
    for lag, tol in {1: 2e-3, 2: 5e-3, 3: 1e-2, 5: 3e-2, 10: 6e-2}.items():
        assert abs(got[lag] - want[lag]) <= tol, (lag, got, want)


# --- channel/beamforming.py -----------------------------------------------


def test_dft_codebook_is_the_jax_packages():
    for n in (16, 64):
        np.testing.assert_array_equal(bf.dft_codebook(n), jbf.dft_codebook(n))
        np.testing.assert_array_equal(bf.dft_codebook_ri(n, device="cpu").numpy(),
                                      np.asarray(jbf.dft_codebook_ri(n)))


def _sweep_both(h, num_selected=4):
    """The beam sweep of ri channel ``h`` (numpy) in JAX and in the port."""
    s = h.shape[3]
    he_j, sel_j = jbf.beam_sweep_project(jnp.asarray(h), jbf.dft_codebook_ri(s), num_selected)
    he_t, sel_t = bf.beam_sweep_project(torch.from_numpy(h),
                                        bf.dft_codebook_ri(s, device="cpu"), num_selected)
    return (np.asarray(he_j), np.asarray(sel_j)), (he_t.numpy(), sel_t.numpy())


@pytest.mark.parametrize("name", ["default", "default_16x2", "calibrated_5"])
def test_beam_sweep_on_jax_channel_matches_jax(name):
    port, ref = MODELS[name]
    h = np.array(jcdl.generate_cdl_channel(jax.random.key(4), ref, 8, 40))
    (he_j, sel_j), (he_t, sel_t) = _sweep_both(h)
    assert he_t.shape == he_j.shape == (8, 40, 4, port.num_ut_ant, 2)
    np.testing.assert_array_equal(sel_t, sel_j)
    assert np.abs(he_t - he_j).max() <= CHANNEL_TOL


def _beam_channel(beams_per_slot, s=16, u=2):
    """A ri channel [1, T, U, S, 2] whose slot t projects onto the beams of
    ``beams_per_slot[t]`` (beam -> amplitude) and onto no other: h is the
    conjugate codebook combination, so (h f)_k = amplitude_k exactly in
    exact arithmetic. ``None`` makes a slot whose 64 beam powers are all
    exactly equal (one antenna at s = N/2, where every DFT weight is
    1/sqrt(N))."""
    cb = bf.dft_codebook(s)
    h = np.zeros((1, len(beams_per_slot), u, s), np.complex64)
    for t, beams in enumerate(beams_per_slot):
        if beams is None:
            h[0, t, :, s // 2] = 1.0
            continue
        for k, amp in beams.items():
            h[0, t] += amp * np.conj(cb[:, k])
    return np.stack([h.real, h.imag], axis=-1).astype(np.float32)


def test_beam_sweep_count_ties_keep_lowest_index_first():
    """Four beams win every slot: all four count T, and ``selected`` is in
    ascending beam order, as ``jax.lax.top_k`` orders ties."""
    slots = [{12: 3.0, 3: 2.5, 9: 2.0, 5: 1.5}] * 10
    (he_j, sel_j), (he_t, sel_t) = _sweep_both(_beam_channel(slots))
    np.testing.assert_array_equal(sel_j, [[3, 5, 9, 12]])
    np.testing.assert_array_equal(sel_t, sel_j)
    assert np.abs(he_t - he_j).max() <= CHANNEL_TOL


def test_beam_sweep_ties_inside_a_slots_ranking():
    """Slots where every beam's power is exactly equal (their top 4 are beams
    0-3, lowest index first), mixed with slots won by other beams, so that
    eight beams tie in the histogram: ``selected`` is JAX's."""
    slots = [None] * 6 + [{7: 2.0, 9: 2.0, 11: 1.0, 14: 1.0}] * 6
    h = _beam_channel(slots)
    power = np.sum(np.abs(_to_c(h)[0, 0] @ bf.dft_codebook(16)) ** 2, axis=0)
    assert np.all(power == power[0]), power  # the constructed tie is exact
    (he_j, sel_j), (he_t, sel_t) = _sweep_both(h)
    np.testing.assert_array_equal(sel_j, [[0, 1, 2, 3]])
    np.testing.assert_array_equal(sel_t, sel_j)
    assert np.abs(he_t - he_j).max() <= CHANNEL_TOL
    # With the tied slots outnumbered, the other slots' winners are kept.
    (he_j, sel_j), (he_t, sel_t) = _sweep_both(_beam_channel(slots[3:]))
    np.testing.assert_array_equal(sel_j, [[7, 9, 11, 14]])
    np.testing.assert_array_equal(sel_t, sel_j)


def test_standardize_time_series_matches_jax():
    re, im = _rng_arrays((3, 40, 4, 2), seed=3)
    x = np.stack([re * 2 + 1, im - 0.5], axis=-1)
    want = np.asarray(jbf.standardize_time_series(jnp.asarray(x)))
    got = bf.standardize_time_series(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # N - 1 denominator: unit complex variance per (sample, beam, rx)
    var = (got ** 2).sum(axis=(1, 4)) / (x.shape[1] - 1)
    np.testing.assert_allclose(var, 1.0, rtol=1e-5)


# --- channel/dataset.py ----------------------------------------------------


@pytest.mark.parametrize("name", ["default", "calibrated_5"])
def test_beamformed_dataset_from_jax_chunk_draws_matches_jax(name):
    """Three chunks, the last one short (20 samples at batch 8), each fed
    the draws of JAX's own chunk key."""
    port, ref = MODELS[name]
    key = jax.random.key(21)
    want = np.asarray(jds.generate_beamformed_dataset(
        key, model=ref, num_samples=20, num_slots=30, batch_size=8))
    chunks = jax_chunk_keys(key, 20, 8)
    assert [b for _, b in chunks] == [8, 8, 4]
    cb = jbf.dft_codebook_ri(ref.num_bs_ant)
    sel_want = np.concatenate([np.asarray(jbf.beam_sweep_project(
        jcdl.generate_cdl_channel(k, ref, b, 30), cb, 4)[1]) for k, b in chunks])
    got, sel = ds.generate_beamformed_dataset(
        0, model=port, num_samples=20, num_slots=30, batch_size=8, device="cpu",
        draws=[jax_cdl_draws(k, ref, b) for k, b in chunks], return_selected=True)
    assert got.shape == want.shape == (20, 30, 2, 4, 2)
    np.testing.assert_array_equal(sel.numpy(), sel_want)
    assert np.abs(got.numpy() - want).max() <= CHANNEL_TOL


def test_beamformed_dataset_is_a_function_of_key_and_chunk_size():
    """Chunk c draws from the stream keyed (*key, c): a shorter dataset is a
    prefix of a longer one with the same key and chunk size, another key
    differs, and the draws argument must give one draws object a chunk."""
    model = cdl.CDLModel(num_bs_ant=16)
    kw = dict(model=model, num_slots=20, batch_size=4, device="cpu")
    long = ds.generate_beamformed_dataset((7, 0), num_samples=10, **kw)
    short = ds.generate_beamformed_dataset((7, 0), num_samples=8, **kw)
    other = ds.generate_beamformed_dataset((7, 1), num_samples=8, **kw)
    assert torch.equal(long[:8], short)
    assert not torch.allclose(short, other)
    with pytest.raises(ValueError, match="chunks"):
        ds.generate_beamformed_dataset(0, num_samples=10, draws=[None], **kw)


def test_make_window_dataset_and_reference_pickle_round_trip(tmp_path):
    model = cdl.CDLModel(num_bs_ant=16)
    wds = ds.make_window_dataset(3, model=model, num_samples=6, num_slots=25, seq_len=15,
                                 pred_len=5, snr_db=20.0, device="cpu")
    h = ds.generate_beamformed_dataset(3, model=model, num_samples=6, num_slots=25,
                                       device="cpu")
    assert torch.equal(wds.h, pack_features(h)) and wds.h.shape == (6, 25, 16)
    path = tmp_path / "ref.pickle"
    ds.save_reference_format(str(path), h)
    with open(path, "rb") as f:
        arr = pickle.load(f)
    assert arr.dtype == np.complex64 and arr.shape == (6, 25, 2, 4)
    back = WindowDataset.from_pickle(str(path), seq_len=15, pred_len=5, snr_db=20.0,
                                     device="cpu")
    assert torch.equal(back.h, wds.h)
    want = JaxWindowDataset.from_pickle(str(path), seq_len=15, pred_len=5, snr_db=20.0)
    np.testing.assert_array_equal(np.asarray(want.h), wds.h.numpy())


@pytest.mark.parametrize("n,frac", [(20, 0.2), (7, 0.2), (10, 0.35)])
def test_train_val_split_matches_jax(n, frac):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    tr_j, va_j = jds.train_val_split(jnp.asarray(x), frac)
    tr_t, va_t = ds.train_val_split(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(tr_t.numpy(), np.asarray(tr_j))
    np.testing.assert_array_equal(va_t.numpy(), np.asarray(va_j))


# --- channel/interpolate.py --------------------------------------------------


@pytest.mark.parametrize("factor", [1, 3, 8])
@pytest.mark.parametrize("axis", [-2, 1])
def test_interpolate_slots_matches_jax(factor, axis):
    x = np.random.default_rng(4).normal(size=(2, 9, 5, 3)).astype(np.float32)
    want = np.asarray(jinterp.interpolate_slots(jnp.asarray(x), factor, axis))
    got = interpolate.interpolate_slots(torch.from_numpy(x), factor, axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(jinterp._catmull_rom_basis(factor),
                               interpolate._catmull_rom_basis(factor), rtol=0, atol=0)


# --- the sharded variants (4 gloo ranks) ------------------------------------


@pytest.fixture(scope="module")
def sharded_channel(tmp_path_factory):
    """One group of 4 gloo ranks (``tests/torch_parallel_worker.py``): the
    antenna-sharded sweep of a JAX CDL channel and the sample-sharded
    dataset."""
    h = np.array(jcdl.generate_cdl_channel(jax.random.key(6), MODELS["default_16x2"][1], 4, 20))
    outs = spawn(tmp_path_factory.mktemp("sharded_channel"), ["beam_sweep", "sharded_dataset"],
                 4, {"sweep_h": torch.from_numpy(h)})
    return h, outs


def test_antenna_sharded_sweep_matches_jax(sharded_channel):
    """``beam_sweep_project_sharded`` on a model=4 mesh of 4 ranks (16
    antennas, 4 a rank) against JAX's on a model=4 sub-mesh of the virtual
    devices: the selected beams equal, ``h_eff`` within the sweep's
    tolerance, on every rank, and within it of the unsharded sweep."""
    h, outs = sharded_channel
    mesh = jax_make_mesh(data=1, model=4, devices=jax.devices()[:4])
    he_j, sel_j = jbf.beam_sweep_project_sharded(jnp.asarray(h), jbf.dft_codebook_ri(16), 4,
                                                 mesh)
    he_t, sel_t = bf.beam_sweep_project(torch.from_numpy(h), bf.dft_codebook_ri(16, device="cpu"))
    for out in outs:
        np.testing.assert_array_equal(out["beam_sweep"]["selected"].numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(out["beam_sweep"]["selected"].numpy(), sel_t.numpy())
        got = out["beam_sweep"]["h_eff"].numpy()
        assert np.abs(got - np.asarray(he_j)).max() <= CHANNEL_TOL
        assert np.abs(got - he_t.numpy()).max() <= CHANNEL_TOL


def test_sample_sharded_dataset_shards_are_the_keyed_streams(sharded_channel):
    """``generate_beamformed_dataset_sharded`` on a data=4 mesh: rank r's
    shard is the unsharded generator's output on the key path
    ``(*key, r)``, bit for bit, and a sample count the axis does not divide
    is refused with JAX's message."""
    _, outs = sharded_channel
    for r, out in enumerate(outs):
        want = ds.generate_beamformed_dataset((5, 1, r), model=cdl.CDLModel(num_bs_ant=16),
                                              num_samples=2, num_slots=10, device="cpu")
        assert torch.equal(out["sharded_dataset"]["shard"], want)
        assert out["sharded_dataset"]["refused"] == (
            "num_samples 9 not divisible by data axis size 4")
    shards = [out["sharded_dataset"]["shard"] for out in outs]
    assert not torch.equal(shards[0], shards[1])
