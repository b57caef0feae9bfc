"""Blockwise streaming in the port against the JAX package's
(``models/streaming.py``) and ``DataEmbedding``'s ``position_offset``
(``models/embed.py:90-102``), on the CPU, with shared weights.

- ``push_block`` against JAX's, window and counters, block by block.
- ``streaming_step`` against JAX's for the blocks before and after the
  window fills, and ``streaming_rollout`` against JAX's ``lax.scan``
  rollout, at atol 1e-5; the full-window prediction equals the offline
  forward.
- The JAX fault the port keeps: the docstrings promise absolute positions,
  but ``streaming_step`` never passes ``state.position`` to the model, so a
  prediction does not depend on it (in JAX and in the port).
- ``position_offset`` at 0, inside the 8,192-slot span and past it, where
  ``lax.dynamic_slice`` clamps, against flax's ``DataEmbedding``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import streaming as jst
from channelestimationtransformer_tpu.models.embed import DataEmbedding as JaxDataEmbedding

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models import streaming as tst
from channelestimationtransformer_torch.models.embed import DataEmbedding

from test_torch_informer import _load_module, _model_pair, _variables

ATOL = 1e-5
CFG = dict(seq_len=20, label_len=5, pred_len=5, d_model=32, n_heads=4, e_layers=(2, 1),
           d_layers=1, d_ff=16, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    fmod, tmod, params, stats, _, _ = _model_pair(rng, 2, **CFG)
    stream = rng.normal(size=(2, 40, 16)).astype(np.float32)
    return fmod, tmod, {"params": params, "batch_stats": stats}, stream


def test_push_block_matches_jax():
    cfg = InformerConfig(**CFG)
    jstate = jst.init_stream(2, JaxInformerConfig(**CFG))
    tstate = tst.init_stream(2, cfg, device="cpu")
    window = tstate.window
    rng = np.random.default_rng(1)
    for k in (5, 3, 20, 5):
        blk = rng.normal(size=(2, k, 16)).astype(np.float32)
        jstate = jst.push_block(jstate, jnp.asarray(blk))
        tstate = tst.push_block(tstate, torch.from_numpy(blk))
        np.testing.assert_array_equal(tstate.window.numpy(), np.asarray(jstate.window))
        assert (tstate.position, tstate.filled) == (int(jstate.position), int(jstate.filled))
    assert tstate.window is window and window.dtype == torch.float32  # updated in place
    assert (tstate.position, tstate.filled) == (33, 20)
    with pytest.raises(ValueError, match="does not fit"):
        tst.push_block(tstate, torch.zeros(2, 21, 16))


def test_streaming_step_matches_jax_before_and_after_the_window_fills(pair):
    fmod, tmod, variables, stream = pair
    jcfg, cfg = JaxInformerConfig(**CFG), InformerConfig(**CFG)
    jstate = jst.init_stream(2, jcfg)
    tstate = tst.init_stream(2, cfg, device="cpu")
    for i in range(8):  # the window fills after 4 blocks
        blk = stream[:, 5 * i:5 * (i + 1)]
        jstate, want = jst.streaming_step(fmod, variables, jstate, jnp.asarray(blk), jcfg)
        with torch.no_grad():
            tstate, got = tst.streaming_step(tmod, tstate, torch.from_numpy(blk), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"block {i}")


def test_streaming_rollout_matches_jax_and_the_offline_forward(pair):
    fmod, tmod, variables, stream = pair
    cfg = InformerConfig(**CFG)
    want = np.asarray(jst.streaming_rollout(fmod, variables, JaxInformerConfig(**CFG),
                                            jnp.asarray(stream), block=5))
    with torch.no_grad():
        got = tst.streaming_rollout(tmod, cfg, torch.from_numpy(stream), block=5)
    assert got.shape == want.shape == (8, 2, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # After block 3 the window is stream[:, :20]: the offline forward's input.
    x_enc = torch.from_numpy(stream[:, :20])
    x_dec = torch.cat([x_enc[:, -cfg.label_len:], torch.zeros(2, cfg.pred_len, 16)], dim=1)
    with torch.no_grad():
        offline = tmod(x_enc, x_dec)
    np.testing.assert_allclose(got[3].numpy(), offline.numpy(), rtol=0, atol=ATOL)


def test_prediction_does_not_depend_on_the_stream_position(pair):
    """The JAX fault, pinned: ``streaming_step`` (``models/streaming.py:83``)
    calls the model without ``state.position``, so the same window predicts
    the same at stream position 0 and 10,000, in JAX and in the port, and
    equals neither embedding at an absolute offset."""
    fmod, tmod, variables, stream = pair
    jcfg, cfg = JaxInformerConfig(**CFG), InformerConfig(**CFG)
    blk = stream[:, :20]
    preds = {}
    for position in (0, 10_000):
        jstate = jst.init_stream(2, jcfg)._replace(position=jnp.asarray(position, jnp.int32))
        _, preds[("jax", position)] = jst.streaming_step(fmod, variables, jstate,
                                                         jnp.asarray(blk), jcfg)
        tstate = tst.init_stream(2, cfg, device="cpu")._replace(position=position)
        with torch.no_grad():
            tstate, preds[("port", position)] = tst.streaming_step(
                tmod, tstate, torch.from_numpy(blk), cfg)
        assert tstate.position == position + 20
    np.testing.assert_array_equal(np.asarray(preds[("jax", 0)]),
                                  np.asarray(preds[("jax", 10_000)]))
    assert torch.equal(preds[("port", 0)], preds[("port", 10_000)])
    # An absolute-position embedding would have changed the prediction.
    emb = tmod.enc_embedding
    x = torch.from_numpy(blk)
    with torch.no_grad():
        assert not torch.allclose(emb(x, position_offset=10_000), emb(x), atol=1e-3)


@pytest.mark.parametrize("offset", [0, 37, 8192, 9000])
def test_position_offset_matches_flax_and_clamps(offset):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    fmod = JaxDataEmbedding(d_model=32, dropout=0.0)
    params, stats = _variables(fmod, rng, x)
    tmod = _load_module(DataEmbedding(16, 32), params, stats, "embedding")
    want = np.asarray(jax.jit(lambda v, a, o: fmod.apply(v, a, position_offset=o))(
        {"params": params}, jnp.asarray(x), jnp.asarray(offset, jnp.int32)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), position_offset=offset)
        tensor_offset = tmod(torch.from_numpy(x), position_offset=torch.tensor(offset))
        relative = tmod(torch.from_numpy(x))
        tok = tmod.token(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got, tensor_offset)
    start = min(offset, 8192)  # past the span, the last 12 rows of the table
    table = tmod.position_table(12 + 8192, torch.float32, "cpu")
    assert torch.equal(got, tok + table[start:start + 12])
    assert torch.equal(got, relative) == (offset == 0)


# --- the driver ---------------------------------------------------------------------

CHANNEL_FLAGS = ("--slot-symbols", "--ue-speed-kmh", "--calibrated")
DRIVER_CFG = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=32)


def test_streaming_driver_flags_match_the_jax_driver():
    """Every flag of ``experiments/train_streaming.py`` (its own and
    ``add_channel_args``'s); the port adds ``--device`` alone (the kernel route
    follows the device, as in ``cli.int8_serving``)."""
    from channelestimationtransformer_torch.cli import train_streaming

    from test_torch_cli import _jax_flags, _port_flags

    want = _jax_flags("experiments/train_streaming.py")
    want.update({k: v for k, v in
                 _jax_flags("channelestimationtransformer_tpu/channel/cdl.py").items()
                 if k in CHANNEL_FLAGS})
    got = _port_flags(train_streaming.build_parser())
    assert set(got) == set(want) | {"--device"}
    for flag in want:
        assert got[flag] == want[flag], flag


def test_streaming_driver_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """A small flagship-length model from its checkpoint, 64 trajectories of
    100 slots (the JAX driver's ``seq_len=95, pred_len=block`` windows), 8
    streams: 20 blocks, 19 per-block NMSEs, the warm mean over the last two
    (the window is full after 18), JAX's keys."""
    import functools
    import json

    from channelestimationtransformer_torch.cli import _study, train_streaming
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
    from channelestimationtransformer_torch.train.trainer import create_train_state

    sizes = []

    def datasets(args, cfg, device, *specs):
        sizes.append((cfg.seq_len, cfg.pred_len, *specs))
        return _study.datasets(args, cfg, device, *((key, min(n, 64)) for key, n in specs))

    monkeypatch.setattr(train_streaming, "InformerConfig",
                        functools.partial(InformerConfig, **DRIVER_CFG))
    monkeypatch.setattr(train_streaming, "datasets", datasets)
    model = build_informer(InformerConfig(**DRIVER_CFG), device="cpu", seed=1)
    ckpt = save_checkpoint(create_train_state(model, TrainConfig()), str(tmp_path), "fp32_", 3)
    out = tmp_path / "stream" / "streaming_results.json"
    res = train_streaming.main(["--device", "cpu", "--checkpoint", ckpt, "--batch", "8",
                                "--calibrated", "--ue-speed-kmh", "5", "--out", str(out)])
    assert sizes == [(95, 5, (7, 1024))]
    assert set(res) == {"block", "per_block_nmse", "warm_window_nmse", "warm_window_nmse_db"}
    assert json.loads(out.read_text()) == res
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    assert res["block"] == 5 and len(res["per_block_nmse"]) == 19
    assert res["warm_window_nmse"] == pytest.approx(np.mean(res["per_block_nmse"][17:]))
    assert res["warm_window_nmse_db"] == pytest.approx(10 * np.log10(res["warm_window_nmse"]))
