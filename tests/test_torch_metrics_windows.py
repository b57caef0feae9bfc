"""The port's metrics and window sampling against the JAX package's.

``make_batch`` is held to JAX's exact batches: the test reproduces JAX's
draws from the same key (``data/windows.py:108-120``) and injects them.
Tolerance rtol 1e-6; atol 1e-6 where a noisy value is the sum of signal and
noise and may cancel towards zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core import metrics as jax_metrics
from channelestimationtransformer_tpu.data.windows import WindowDataset as JaxWindowDataset
from channelestimationtransformer_tpu.data.windows import make_batch as jax_make_batch
from channelestimationtransformer_tpu.data.windows import sample_windows as jax_sample_windows

from channelestimationtransformer_torch.core import metrics
from channelestimationtransformer_torch.data.windows import (
    WindowDataset,
    make_batch,
    sample_windows,
)


@pytest.mark.parametrize("name", ["nmse", "nmse_split"])
def test_nmse_matches_jax(name):
    rng = np.random.default_rng(0)
    x_hat = rng.normal(size=(8, 5, 16)).astype(np.float32)
    x = rng.normal(size=(8, 5, 16)).astype(np.float32)
    want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(x_hat), jnp.asarray(x)))
    got = getattr(metrics, name)(torch.from_numpy(x_hat), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_nmse_split_normalises_by_prediction_power():
    """The reference quirk: the per-horizon NMSE divides by sum(x_hat^2)."""
    x = torch.ones(2, 3, 4)
    x_hat = 2.0 * torch.ones(2, 3, 4)
    np.testing.assert_allclose(metrics.nmse_split(x_hat, x).numpy(), [0.25] * 3)
    np.testing.assert_allclose(metrics.nmse(x_hat, x).item(), 1.0)


def test_nmse_db_matches_jax():
    vals = np.array([1e-3, 0.05, 1.0, 3.0], np.float32)
    np.testing.assert_allclose(metrics.nmse_db(torch.from_numpy(vals)).numpy(),
                               np.asarray(jax_metrics.nmse_db(jnp.asarray(vals))), rtol=1e-6)


def _jax_draws(key, n, slots, length, batch, feat):
    """JAX's own draws in sample_windows, from the same key."""
    k_idx, k_start, k_noise = jax.random.split(key, 3)
    return dict(
        idx=np.array(jax.random.randint(k_idx, (batch,), 0, n)),
        starts=np.array(jax.random.randint(k_start, (batch,), 0, slots - length + 1)),
        noise=np.array(jax.random.normal(k_noise, (batch, slots, feat))),
    )


@pytest.mark.parametrize("seq_len,pred_len,label_len,snr_db", [(24, 5, 6, 21.0), (90, 5, 10, 5.0)])
def test_make_batch_matches_jax(seq_len, pred_len, label_len, snr_db):
    rng = np.random.default_rng(1)
    n, slots, feat, batch = 12, 100, 16, 6
    h = (rng.normal(size=(n, slots, feat)) * rng.uniform(0.1, 3.0, size=(n, 1, 1))).astype(
        np.float32)
    key = jax.random.key(3)
    jds = JaxWindowDataset(h=jnp.asarray(h), seq_len=seq_len, pred_len=pred_len, snr_db=snr_db)
    want = jax_make_batch(key, jds, batch, label_len)

    ds = WindowDataset(h=h, seq_len=seq_len, pred_len=pred_len, snr_db=snr_db, device="cpu")
    draws = _jax_draws(key, n, slots, seq_len + pred_len, batch, feat)
    got = make_batch(ds, batch, label_len, **draws)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)

    got_w = sample_windows(ds, batch, **draws)
    for g, w in zip(got_w, jax_sample_windows(key, jds, batch)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_make_batch_draws_from_generator():
    """Without injected draws the batch comes from the generator: the same
    seed gives the same batch, another seed another, and the windows are
    normalised to unit complex RMS per sample before noise."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(10, 40, 16)).astype(np.float32) * 5.0
    ds = WindowDataset(h=h, seq_len=20, pred_len=5, snr_db=200.0, device="cpu")

    def batch(seed):
        return make_batch(ds, 4, 6, generator=torch.Generator().manual_seed(seed))

    a, b, c = batch(0), batch(0), batch(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    enc_in, dec_in, target = a
    assert enc_in.shape == (4, 20, 16) and dec_in.shape == (4, 11, 16)
    assert target.shape == (4, 5, 16)
    assert torch.equal(dec_in[:, :6], enc_in[:, -6:])
    assert torch.count_nonzero(dec_in[:, 6:]) == 0
    # At 200 dB SNR the noisy history is the clean signal, of unit RMS scale.
    assert 0.3 < torch.sqrt(2 * torch.mean(enc_in ** 2)).item() < 3.0
