"""The port's modules against the JAX package's, with shared weights.

Weights go from the flax variable tree through the port's weight bridge
(``utils/convert.py``); inputs are made with numpy from a seed. Tolerance
rtol 2e-4 / atol 2e-5: float32 on the CPU, with sums taken in another order
by XLA and by torch.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.decoder import DecoderLayer as JaxDecoderLayer
from channelestimationtransformer_tpu.models.embed import DataEmbedding as JaxDataEmbedding
from channelestimationtransformer_tpu.models.encoder import ConvLayer as JaxConvLayer
from channelestimationtransformer_tpu.models.encoder import EncoderLayer as JaxEncoderLayer
from channelestimationtransformer_tpu.train.trainer import eval_step_impl

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.data.windows import WindowDataset
from channelestimationtransformer_torch.models.decoder import DecoderLayer
from channelestimationtransformer_torch.models.embed import DataEmbedding
from channelestimationtransformer_torch.models.encoder import ConvLayer, EncoderLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.train.trainer import eval_step
from channelestimationtransformer_torch.utils.convert import FlaxBridge, from_flax, load_flax

RTOL, ATOL = 2e-4, 2e-5
# The small config of tests/test_torch_crosscheck.py.
SMALL = dict(seq_len=24, label_len=6, pred_len=5, d_model=32, n_heads=4,
             e_layers=(2, 2), d_layers=2, d_ff=32, dropout=0.0)


def _perturb(tree, rng, scale=0.1):
    """Every leaf plus seeded noise (norm scales off 1, biases off 0), so a
    swapped or untransposed leaf cannot go unseen."""
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.normal(size=x.shape).astype(np.float32), tree)


def _random_stats(stats, rng):
    """BatchNorm running statistics away from (0, 1)."""
    def leaf(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        return (0.2 * rng.normal(size=x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _variables(fmod, rng, *args):
    v = jax.jit(fmod.init)(jax.random.key(0), *map(jnp.asarray, args))
    return _perturb(v["params"], rng), _random_stats(v.get("batch_stats", {}), rng)


def _load_module(tmod, params, stats, method):
    """One module through the bridge: ``method`` walks a tree holding just it."""
    bridge = FlaxBridge(params, stats)
    getattr(bridge, method)("")
    bridge.check_consumed()
    tmod.load_state_dict(bridge.state_dict, strict=True)
    return tmod.eval()


def _flax_apply(fmod, params, stats, *args):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    out = jax.jit(fmod.apply)(variables, *map(jnp.asarray, args))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _torch_apply(tmod, *args):
    with torch.no_grad():
        out = tmod(*map(torch.from_numpy, args))
    return (out[0] if isinstance(out, tuple) else out).numpy()


def test_data_embedding_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    fmod = JaxDataEmbedding(d_model=32, dropout=0.0)
    params, stats = _variables(fmod, rng, x)
    tmod = _load_module(DataEmbedding(16, 32), params, stats, "embedding")
    np.testing.assert_allclose(_torch_apply(tmod, x), _flax_apply(fmod, params, stats, x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("length", [21, 12])
def test_convlayer_eval_batchnorm_matches_flax(length):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, length, 32)).astype(np.float32)
    fmod = JaxConvLayer(d_model=32)
    params, stats = _variables(fmod, rng, x)
    tmod = _load_module(ConvLayer(32), params, stats, "distil")
    got = _torch_apply(tmod, x)
    want = _flax_apply(fmod, params, stats, x)
    assert got.shape == want.shape == (2, (length - 1) // 2 + 1, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_encoder_layer_matches_flax(pre_norm):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 23, 32)).astype(np.float32)
    fmod = JaxEncoderLayer(d_model=32, n_heads=4, d_ff=48, dropout=0.0,
                           activation="gelu", pre_norm=pre_norm)
    params, stats = _variables(fmod, rng, x)
    tmod = _load_module(EncoderLayer(32, n_heads=4, d_ff=48, activation="gelu",
                                     pre_norm=pre_norm), params, stats, "encoder_layer")
    np.testing.assert_allclose(_torch_apply(tmod, x), _flax_apply(fmod, params, stats, x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mix,pre_norm,activation",
                         [(True, False, "gelu"), (False, False, "relu"), (True, True, "gelu")])
def test_decoder_layer_matches_flax(mix, pre_norm, activation):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    cross = rng.normal(size=(2, 17, 32)).astype(np.float32)
    fmod = JaxDecoderLayer(d_model=32, n_heads=4, d_ff=48, dropout=0.0,
                           activation=activation, mix=mix, pre_norm=pre_norm)
    params, stats = _variables(fmod, rng, x, cross)
    tmod = _load_module(DecoderLayer(32, n_heads=4, d_ff=48, activation=activation,
                                     mix=mix, pre_norm=pre_norm),
                        params, stats, "decoder_layer")
    np.testing.assert_allclose(_torch_apply(tmod, x, cross),
                               _flax_apply(fmod, params, stats, x, cross),
                               rtol=RTOL, atol=ATOL)


def _model_pair(rng, batch, *, jax_pallas=False, port_pallas=False, **cfg_kwargs):
    """A flax model and the port's, sharing perturbed weights, plus inputs."""
    jcfg = JaxInformerConfig(use_pallas=jax_pallas, **cfg_kwargs)
    fmod = jax_build_informer(jcfg)
    x_enc = rng.normal(size=(batch, jcfg.seq_len, jcfg.enc_in)).astype(np.float32)
    x_dec = rng.normal(size=(batch, jcfg.dec_len, jcfg.dec_in)).astype(np.float32)
    params, stats = _variables(fmod, rng, x_enc, x_dec)
    tmod = build_informer(InformerConfig(use_pallas=port_pallas, **cfg_kwargs), device="cpu")
    load_flax(tmod, params, stats)
    return fmod, tmod, params, stats, x_enc, x_dec


@pytest.mark.parametrize("use_pallas", [False, True])
def test_informer_stack_matches_flax(use_pallas):
    """Whole InformerStack at the small config. With use_pallas the JAX side
    runs the Pallas kernel in interpret mode and the port its kernel's
    wrapper (whose CPU path is the plain version)."""
    rng = np.random.default_rng(4)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(
        rng, 3, jax_pallas=use_pallas, port_pallas=use_pallas, **SMALL)
    got = _torch_apply(tmod, x_enc, x_dec)
    assert got.shape == (3, SMALL["pred_len"], 16)
    np.testing.assert_allclose(got, _flax_apply(fmod, params, stats, x_enc, x_dec),
                               rtol=RTOL, atol=ATOL)


def test_single_encoder_informer_matches_flax():
    rng = np.random.default_rng(5)
    cfg = dict(SMALL, e_layers=(3,), pre_norm=True, activation="relu")
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 2, **cfg)
    np.testing.assert_allclose(_torch_apply(tmod, x_enc, x_dec),
                               _flax_apply(fmod, params, stats, x_enc, x_dec),
                               rtol=RTOL, atol=ATOL)


def test_flagship_width_forward_matches_flax():
    """InformerConfig() at full width, batch 2: the port's kernel route
    (plain version on CPU) against the JAX package's XLA path."""
    rng = np.random.default_rng(6)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 2, port_pallas=True)
    np.testing.assert_allclose(_torch_apply(tmod, x_enc, x_dec),
                               _flax_apply(fmod, params, stats, x_enc, x_dec),
                               rtol=RTOL, atol=ATOL)


def test_eval_step_matches_eval_step_impl():
    """The port's eval_step on JAX's exact draws, injected, against
    eval_step_impl (``train/trainer.py:266-287``)."""
    rng = np.random.default_rng(7)
    fmod, tmod, params, stats, _, _ = _model_pair(rng, 2, **SMALL)
    n, slots, feat, batch = 24, 40, 16, 8
    h = rng.normal(size=(n, slots, feat)).astype(np.float32)
    seq_len, pred_len, label_len = SMALL["seq_len"], SMALL["pred_len"], SMALL["label_len"]
    state = types.SimpleNamespace(apply_fn=fmod.apply, params=params, batch_stats=stats)
    step_rng = jax.random.key(11)
    want = jax.jit(lambda h_, key: eval_step_impl(
        state, h_, key, batch_size=batch, label_len=label_len, seq_len=seq_len,
        pred_len=pred_len, snr_db=15.0))(jnp.asarray(h), step_rng)

    k_data, _ = jax.random.split(step_rng)
    k_idx, k_start, k_noise = jax.random.split(k_data, 3)
    draws = dict(
        idx=np.array(jax.random.randint(k_idx, (batch,), 0, n)),
        starts=np.array(jax.random.randint(
            k_start, (batch,), 0, slots - seq_len - pred_len + 1)),
        noise=np.array(jax.random.normal(k_noise, (batch, slots, feat))),
    )
    ds = WindowDataset(h=h, seq_len=seq_len, pred_len=pred_len, snr_db=15.0, device="cpu")
    got = eval_step(tmod, ds, batch_size=batch, label_len=label_len, **draws)
    np.testing.assert_allclose(got["nmse"].numpy(), np.asarray(want["nmse"]), rtol=RTOL)
    np.testing.assert_allclose(got["split"].numpy(), np.asarray(want["split"]), rtol=RTOL)


@pytest.fixture(scope="module")
def small_tree():
    cfg = JaxInformerConfig(**SMALL)
    v = jax.jit(jax_build_informer(cfg).init)(
        jax.random.key(0), jnp.zeros((1, cfg.seq_len, 16)), jnp.zeros((1, cfg.dec_len, 16)))
    tree = jax.tree.map(np.asarray, (v["params"], v["batch_stats"]))
    # A fresh nested-dict copy per use: the tests edit it.
    return lambda: jax.tree.map(np.copy, tree)


def test_from_flax_raises_on_extra_leaf(small_tree):
    params, stats = small_tree()
    params["encoder"]["encoder_0"]["layer_0"]["attention"]["extra"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        from_flax(params, stats)
    params, stats = small_tree()
    stats["encoder"]["encoder_1"]["distil_0"]["norm"]["count"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="count"):
        from_flax(params, stats)


def test_from_flax_raises_on_missing_leaf(small_tree):
    params, stats = small_tree()
    del params["decoder"]["layer_1"]["cross_attention"]["value"]["bias"]
    with pytest.raises(KeyError, match="cross_attention.value.bias"):
        from_flax(params, stats)
    # A whole layer missing: the walk cannot know, the strict load does.
    params, stats = small_tree()
    del params["decoder"]["layer_1"]
    model = build_informer(InformerConfig(**SMALL), device="cpu")
    with pytest.raises(RuntimeError, match="decoder.layer_1"):
        load_flax(model, params, stats)
