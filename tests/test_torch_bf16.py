"""The port in bfloat16 (``InformerConfig(dtype="bfloat16")``) against the
JAX package's bf16 models on the CPU, with shared weights.

flax runs ``dtype`` as "parameters f32, compute in dtype": each dense layer
and conv casts its f32 weight (and x) to bf16; LayerNorm and BatchNorm take
their statistics and normalise in f32 and round the result to bf16; LSQ
quantizes the f32 weight and casts the quantized weight. The port follows
the same rounding points, module by module. The two frameworks still round
at different places inside a chain (XLA on the CPU fuses bf16 elementwise
chains in f32 and rounds at the fusion's output; eager torch rounds after
each op), so values agree to a few bf16 ulps (2^-8 relative) per layer,
not bit for bit. Errors are ``max|port - jax| / max|jax|``:

- one module (embedding, ConvLayer in eval and train mode, encoder and
  decoder layers pre- and post-norm, ``DenseLSQ``): <= 2e-2;
- a whole model (the small InformerStack on the plain and kernel routes,
  its prob and fused variants, LSQ-fibbinary, PTQ weights, the flagship
  width): <= 5e-2, and NMSE(port, jax) <= 1e-3. The long-wide shape that routes to mha: <= 1e-1 and NMSE
  <= 3e-3, since there the two sides round at different points by design:
  mha's plain version (as its kernel) computes softmax(QK^T)V in f32 and
  rounds once, JAX's CPU route is XLA attention in bf16;
- every whole model is also held to the f32 model with the same weights:
  NMSE(port bf16, f32) <= 1.5 x NMSE(jax bf16, f32), i.e. the port's bf16
  is as accurate as the JAX package's;
- one training step: each gradient within 1.5e-1 of its own max abs
  (floor: 5e-2 of the largest gradient's). Every backward op rounds its
  cotangent to bf16 on both sides, so the first layers' gradients sit
  5-15% of their max from the f32 gradients in either framework; hence
  also: the port's worst gradient error against its own f32 gradients is
  at most 1.25 x JAX's against JAX's. BatchNorm statistics (f32) and the
  loss within 2e-2 relative.

Exact: the parameters, BatchNorm statistics, gradients and Adam state stay
f32; PTQ weights equal JAX's; ``from_flax`` of a bf16 config's params is
that of the f32 config's.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.core.metrics import nmse as jax_nmse
from channelestimationtransformer_tpu.core.metrics import nmse_split as jax_nmse_split
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.decoder import DecoderLayer as JaxDecoderLayer
from channelestimationtransformer_tpu.models.embed import DataEmbedding as JaxDataEmbedding
from channelestimationtransformer_tpu.models.encoder import ConvLayer as JaxConvLayer
from channelestimationtransformer_tpu.models.encoder import EncoderLayer as JaxEncoderLayer
from channelestimationtransformer_tpu.models.informer_lsq import (
    build_informer_lsq as jax_build_informer_lsq,
)
from channelestimationtransformer_tpu.ops import quant as jq
from channelestimationtransformer_tpu.ops.quant import lsq as jlsq
from channelestimationtransformer_tpu.ops.quant import settings as jq_settings
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _apply as jax_apply
from channelestimationtransformer_tpu.train.trainer import _update as jax_update
from channelestimationtransformer_tpu.train.trainer import eval_step_impl

from channelestimationtransformer_torch.core.config import (
    InformerConfig,
    TrainConfig,
    activation_dtype,
)
from channelestimationtransformer_torch.core.metrics import nmse, nmse_split
from channelestimationtransformer_torch.data.windows import WindowDataset
from channelestimationtransformer_torch.models import attention
from channelestimationtransformer_torch.models.decoder import DecoderLayer
from channelestimationtransformer_torch.models.dropout import dropout
from channelestimationtransformer_torch.models.embed import DataEmbedding
from channelestimationtransformer_torch.models.encoder import ConvLayer, EncoderLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.models.informer_lsq import build_informer_lsq
from channelestimationtransformer_torch.ops import quant as tq
from channelestimationtransformer_torch.ops.quant import lsq as tlsq
from channelestimationtransformer_torch.train.trainer import (
    apply_gradients,
    create_train_state,
    eval_step,
)
from channelestimationtransformer_torch.utils.convert import FlaxBridge, from_flax, load_flax

from test_torch_informer import LONG, SMALL, _load_module, _perturb, _random_stats
from test_torch_training import _grad_recorder

MODULE_TOL = 2e-2  # max|port - jax| / max|jax|, one module
MODEL_TOL = (5e-2, 1e-3)  # the same over a whole model, and NMSE(port, jax)
MHA_TOL = (1e-1, 3e-3)  # the long-wide shape (module docstring)
F32_RATIO = 1.5  # NMSE(port bf16, f32) over NMSE(jax bf16, f32), at most
GRAD_TOL, GRAD_FLOOR, GRAD_RATIO = 1.5e-1, 5e-2, 1.25  # one training step (module docstring)


def _f32(a):
    """A torch tensor or a JAX / numpy array (bf16 included) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel_err(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _nmse(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.sum((got - want) ** 2) / np.sum(want ** 2))


def _bf16_pair(x, dtype="bfloat16"):
    """The same ``dtype`` values (bf16 by default) as a torch tensor and a
    JAX array (both round the float32 input to nearest even)."""
    return torch.from_numpy(x).to(getattr(torch, dtype)), jnp.asarray(x).astype(dtype)


def _init(fmod, rng, *args):
    """Perturbed params and random BatchNorm statistics of a flax module,
    initialised on ``args`` (JAX arrays)."""
    v = jax.jit(fmod.init)(jax.random.key(0), *args)
    return _perturb(v["params"], rng), _random_stats(v.get("batch_stats", {}), rng)


def _apply(fmod, params, stats, *args, **kwargs):
    variables = {"params": params} | ({"batch_stats": stats} if stats else {})
    return jax.jit(lambda v, *a: fmod.apply(v, *a, **kwargs))(variables, *args)


def test_activation_dtype_maps_the_config_strings():
    """Each float string maps to the dtype JAX computes it in (x64 off, as the
    JAX package runs): float16's aliases to float16; float64's to float32,
    with a ``UserWarning`` where the port narrows it, as JAX does."""
    assert activation_dtype("float32") is torch.float32
    assert activation_dtype("bfloat16") is torch.bfloat16
    for name in ("float16", "half", "f2", "float64", "double"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = activation_dtype(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # JAX warns where it narrows float64
            want = jnp.zeros((), dtype=name).dtype
        assert str(got) == f"torch.{want}", name
        narrowed = np.dtype(name) != want
        assert narrowed == (name in ("float64", "double"))
        assert [w.category for w in caught] == ([UserWarning] if narrowed else []), name
    with pytest.raises(NotImplementedError, match="float16"):
        activation_dtype("longdouble")
    for name in ("int32", "bf16", "nope"):
        with pytest.raises(ValueError, match="float dtype"):
            activation_dtype(name)


# --- modules -----------------------------------------------------------------

def test_bf16_data_embedding_matches_flax():
    """f32 input, cast by the embedding; conv, position table and sum in bf16."""
    _check_data_embedding()


def _check_module_out(got, want, dtype, tol):
    assert got.dtype == getattr(torch, dtype) and want.dtype == jnp.dtype(dtype)
    assert _rel_err(got, want) <= tol


def _check_data_embedding(dtype="bfloat16", tol=MODULE_TOL):
    rng = np.random.default_rng(30)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    fmod = JaxDataEmbedding(d_model=32, dropout=0.0, dtype=jnp.dtype(dtype))
    params, stats = _init(fmod, rng, jnp.asarray(x))
    tmod = _load_module(DataEmbedding(16, 32, dtype=getattr(torch, dtype)), params, stats,
                        "embedding")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _check_module_out(got, _apply(fmod, params, stats, jnp.asarray(x)), dtype, tol)


@pytest.mark.parametrize("train", [False, True])
def test_bf16_convlayer_matches_flax(train):
    """Conv in bf16; BatchNorm with its running statistics (eval) or batch
    statistics (train, updating the f32 running ones) taken in f32."""
    _check_convlayer(train)


def _check_convlayer(train, dtype="bfloat16", tol=MODULE_TOL):
    rng = np.random.default_rng(31)
    x = (2.0 * rng.normal(size=(2, 21, 32)) + 0.5).astype(np.float32)
    tx, jx = _bf16_pair(x, dtype)
    fmod = JaxConvLayer(d_model=32, dtype=jnp.dtype(dtype))
    params, stats = _init(fmod, rng, jx)
    tmod = _load_module(ConvLayer(32, getattr(torch, dtype)), params, stats, "distil")
    if train:
        want, updates = _apply(fmod, params, stats, jx, deterministic=False,
                               mutable=["batch_stats"])
        got = tmod.train()(tx)
        new = updates["batch_stats"]["norm"]
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            stat = getattr(tmod.norm, name)
            assert stat.dtype == torch.float32 and new[key].dtype == jnp.float32
            np.testing.assert_allclose(stat.numpy(), np.asarray(new[key]), rtol=1e-2, atol=1e-3)
    else:
        want = _apply(fmod, params, stats, jx)
        with torch.no_grad():
            got = tmod(tx)
    _check_module_out(got, want, dtype, tol)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_bf16_encoder_layer_matches_flax(pre_norm):
    _check_encoder_layer(pre_norm)


def _check_encoder_layer(pre_norm, dtype="bfloat16", tol=MODULE_TOL):
    rng = np.random.default_rng(32)
    tx, jx = _bf16_pair(rng.normal(size=(2, 23, 32)).astype(np.float32), dtype)
    fmod = JaxEncoderLayer(d_model=32, n_heads=4, d_ff=48, dropout=0.0, activation="gelu",
                           pre_norm=pre_norm, dtype=jnp.dtype(dtype))
    params, stats = _init(fmod, rng, jx)
    tmod = _load_module(EncoderLayer(32, n_heads=4, d_ff=48, activation="gelu",
                                     pre_norm=pre_norm, dtype=getattr(torch, dtype)),
                        params, stats, "encoder_layer")
    with torch.no_grad():
        got = tmod(tx)[0]
    _check_module_out(got, _apply(fmod, params, stats, jx)[0], dtype, tol)


@pytest.mark.parametrize("mix,pre_norm", [(True, False), (True, True), (False, False)])
def test_bf16_decoder_layer_matches_flax(mix, pre_norm):
    _check_decoder_layer(mix, pre_norm)


def _check_decoder_layer(mix, pre_norm, dtype="bfloat16", tol=MODULE_TOL):
    rng = np.random.default_rng(33)
    tx, jx = _bf16_pair(rng.normal(size=(2, 11, 32)).astype(np.float32), dtype)
    tc, jc = _bf16_pair(rng.normal(size=(2, 17, 32)).astype(np.float32), dtype)
    fmod = JaxDecoderLayer(d_model=32, n_heads=4, d_ff=48, dropout=0.0, activation="gelu",
                           mix=mix, pre_norm=pre_norm, dtype=jnp.dtype(dtype))
    params, stats = _init(fmod, rng, jx, jc)
    tmod = _load_module(DecoderLayer(32, n_heads=4, d_ff=48, activation="gelu", mix=mix,
                                     pre_norm=pre_norm, dtype=getattr(torch, dtype)),
                        params, stats, "decoder_layer")
    with torch.no_grad():
        got = tmod(tx, tc)
    _check_module_out(got, _apply(fmod, params, stats, jx, jc), dtype, tol)


@pytest.mark.parametrize("fibbinary", [False, True])
def test_bf16_dense_lsq_matches_flax(fibbinary):
    """The f32 weight quantized in f32 (the same codes as at f32), then the
    quantized weight, the bias and x in bf16 (JAX ``lsq.py:97-104``)."""
    _check_dense_lsq(fibbinary)


def _check_dense_lsq(fibbinary, dtype="bfloat16", tol=MODULE_TOL):
    rng = np.random.default_rng(34)
    tx, jx = _bf16_pair(rng.normal(size=(2, 7, 24)).astype(np.float32), dtype)
    fmod = jlsq.DenseLSQ(40, nbits=8, quantize=True, fibbinary=fibbinary, dtype=jnp.dtype(dtype))
    params = jax.tree.map(np.asarray, jax.jit(fmod.init)(jax.random.key(1), jx)["params"])
    params["bias"] = rng.normal(size=40).astype(np.float32) * 0.1
    bridge = FlaxBridge(params)
    bridge.dense("")
    bridge.check_consumed()
    tmod = tlsq.DenseLSQ(24, 40, nbits=8, fibbinary=fibbinary, dtype=getattr(torch, dtype))
    tmod.load_state_dict(bridge.state_dict, strict=True)
    with torch.no_grad():
        got = tmod(tx)
    _check_module_out(got, jax.jit(fmod.apply)({"params": params}, jx), dtype, tol)


def test_bf16_dropout_rounds_once():
    """Kept values are ``x / (1 - rate)`` rounded once to bf16, as flax's
    ``where(mask, x / keep_prob, 0)`` (a bf16 mask scaled by ``1 / 0.95``
    would be off by 0.2%); the keep rate is 0.95 within 5 sigma; the mask is
    the one the same generator gives an f32 input, as flax's masks do not
    depend on the dtype."""
    x = torch.randn(64, 90, 32)
    xb = x.to(torch.bfloat16)
    p = 0.05
    out = dropout(xb, p, torch.Generator().manual_seed(0), True)
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(kept, dropout(x, p, torch.Generator().manual_seed(0), True) != 0)
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / xb.numel())
    assert torch.equal(out[kept], (xb / (1 - p))[kept])


# --- whole models ------------------------------------------------------------

def _bf16_model_pair(rng, batch, *, jax_pallas=False, port_pallas=False, dtype="bfloat16",
                     **cfg_kwargs):
    """A flax model and the port's in ``dtype`` (bf16 by default), sharing
    perturbed f32 weights, plus f32 inputs (the models cast them)."""
    jcfg = JaxInformerConfig(use_pallas=jax_pallas, dtype=dtype, **cfg_kwargs)
    fmod = jax_build_informer(jcfg)
    x_enc = rng.normal(size=(batch, jcfg.seq_len, jcfg.enc_in)).astype(np.float32)
    x_dec = rng.normal(size=(batch, jcfg.dec_len, jcfg.dec_in)).astype(np.float32)
    params, stats = _init(fmod, rng, jnp.asarray(x_enc), jnp.asarray(x_dec))
    tmod = build_informer(InformerConfig(use_pallas=port_pallas, dtype=dtype, **cfg_kwargs),
                          device="cpu")
    load_flax(tmod, params, stats)
    return fmod, tmod, params, stats, x_enc, x_dec


def _check_forward(fmod, tmod, params, stats, x_enc, x_dec, tol=MODEL_TOL, ratio=F32_RATIO):
    """The port's forward against flax's in the model's dtype (bf16 here;
    ``tol``: max relative error, NMSE), and both against flax's f32 forward
    on the same weights (``ratio``, of the NMSEs)."""
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    inputs = jnp.asarray(x_enc), jnp.asarray(x_dec)
    want = _apply(fmod, params, stats, *inputs)
    f32 = _apply(fmod.clone(config=dataclasses.replace(fmod.config, dtype="float32")),
                 params, stats, *inputs)
    dtype = fmod.config.dtype
    assert got.dtype == getattr(torch, dtype) and want.dtype == jnp.dtype(dtype)
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in tmod.buffers())
    assert _rel_err(got, want) <= tol[0] and _nmse(got, want) <= tol[1]
    assert _nmse(got, f32) <= ratio * _nmse(want, f32)
    return got


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_informer_stack_matches_flax(use_pallas):
    """The small InformerStack in bf16. With use_pallas the JAX side runs the
    bd Pallas kernel in interpret mode (f32 inside, bf16 out) and the port
    its kernel's wrapper (its plain version on the CPU, the same rounding);
    without, both run their plain attention in bf16."""
    rng = np.random.default_rng(35)
    _check_forward(*_bf16_model_pair(rng, 3, jax_pallas=use_pallas, port_pallas=use_pallas,
                                     **SMALL))


@pytest.fixture
def one_torch_thread():
    """torch on one thread for a test of many small ops, which the default
    intra-op pool slows several-fold on a shared machine (as under
    pytest-xdist's workers); restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["prob", "fused"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_prob_and_fused_stacks_match_flax(name, use_pallas, monkeypatch, one_torch_thread):
    """The small prob InformerStack of ``tests/test_torch_prob_attention.py``
    (flax applied unjitted, JAX's ``index_sample`` draws injected) and the
    small fused one in bf16, on the kernel route and the plain path, against
    flax's bf16: ``MODEL_TOL``, and no further from the f32 model than
    flax's bf16 is (``F32_RATIO``)."""
    _check_prob_or_fused(name, use_pallas, monkeypatch)


def _check_prob_or_fused(name, use_pallas, monkeypatch, dtype="bfloat16", tol=MODEL_TOL,
                         ratio=F32_RATIO, f32_draws=False):
    """``f32_draws``: record JAX's prob draws from the f32 model applied
    unjitted (the same key gives the same draws in any dtype) and apply the
    ``dtype`` model jitted, where an unjitted f16 apply is slow on the CPU."""
    from test_torch_prob_attention import PROB_SMALL, _Draws

    rng = np.random.default_rng(37)
    cfg = PROB_SMALL if name == "prob" else dict(SMALL, fuse_qkv=True)
    fmod, tmod, params, stats, x_enc, x_dec = _bf16_model_pair(rng, 3, port_pallas=use_pallas,
                                                               dtype=dtype, **cfg)
    variables = {"params": params, "batch_stats": stats}
    inputs, kw = (jnp.asarray(x_enc), jnp.asarray(x_dec)), dict(rngs={"sample": jax.random.key(3)})
    f32_apply = fmod.clone(config=dataclasses.replace(fmod.config, dtype="float32")).apply
    if f32_draws and name == "prob":
        randint = jax.random.randint
        draws = _Draws(monkeypatch)
        f32 = f32_apply(variables, *inputs, **kw)
        monkeypatch.setattr(jax.random, "randint", randint)  # recorded: trace freely
        want = jax.jit(fmod.apply)(variables, *inputs, **kw)
    else:
        f32 = jax.jit(f32_apply)(variables, *inputs, **kw)  # the same key: the same draws
        draws = _Draws(monkeypatch)
        want = (fmod.apply if name == "prob" else jax.jit(fmod.apply))(variables, *inputs, **kw)
    left = draws.inject()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    assert left == [] and got.dtype == getattr(torch, dtype) and want.dtype == jnp.dtype(dtype)
    assert _rel_err(got, want) <= tol[0] and _nmse(got, want) <= tol[1]
    assert _nmse(got, f32) <= ratio * _nmse(want, f32)


def test_bf16_flagship_width_forward_matches_flax():
    """``bench.py``'s config, ``InformerConfig(use_pallas=True,
    dtype="bfloat16")``, batch 2: the port's kernel route against the JAX
    package's XLA path."""
    rng = np.random.default_rng(36)
    _check_forward(*_bf16_model_pair(rng, 2, jax_pallas=True, port_pallas=True))


def test_bf16_long_wide_eval_forward_goes_through_mha_attention(monkeypatch):
    """seq_len 160, E 128 in bf16 with use_pallas: every attention call
    reaches mha_attention with bf16 q, k, v (its plain version on the CPU:
    f32 math, bf16 out), against flax's XLA attention in bf16."""
    _check_long_wide(monkeypatch)


def _check_long_wide(monkeypatch, dtype="bfloat16", tol=MHA_TOL, ratio=F32_RATIO):
    calls = []
    real = attention.mha_attention
    monkeypatch.setattr(attention, "mha_attention", lambda q, k, v, **kw: (
        calls.append((q.shape[1], k.shape[1], q.dtype)) or real(q, k, v, **kw)))
    monkeypatch.setattr(attention, "bd_attention",
                        lambda *a, **k: pytest.fail("bd_attention took a long-wide call"))
    rng = np.random.default_rng(37)
    _check_forward(*_bf16_model_pair(rng, 2, port_pallas=True, dtype=dtype, **LONG), tol=tol,
                   ratio=ratio)
    dt = getattr(torch, dtype)
    assert sorted(calls) == [(15, 15, dt), (15, 160, dt), (80, 80, dt), (80, 80, dt),
                             (160, 160, dt)]


@pytest.mark.parametrize("fibbinary", [True, False])
def test_bf16_lsq_informer_matches_flax(fibbinary):
    """LSQ-fibbinary (and LSQ) in bf16, eval, use_pallas on both sides
    (the port's snap through its kernel wrapper), against
    ``build_informer_lsq``."""
    _check_lsq_informer(fibbinary)


def _check_lsq_informer(fibbinary, dtype="bfloat16", tol=MODEL_TOL, ratio=F32_RATIO):
    rng = np.random.default_rng(38)
    cfg = dict(SMALL, e_layers=(2, 1), d_layers=1, use_pallas=True, dtype=dtype)
    fmod = jax_build_informer_lsq(JaxInformerConfig(**cfg), nbits=8, fibbinary=fibbinary)
    x_enc = rng.normal(size=(3, SMALL["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(3, SMALL["label_len"] + SMALL["pred_len"], 16)).astype(np.float32)
    v = jax.jit(fmod.init)(jax.random.key(0), jnp.asarray(x_enc), jnp.asarray(x_dec))

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "step_size":
            return (a * rng.uniform(0.8, 1.2)).astype(np.float32)
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    stats = _random_stats(v["batch_stats"], rng)
    tmod = build_informer_lsq(InformerConfig(**cfg), nbits=8, fibbinary=fibbinary, device="cpu")
    load_flax(tmod, params, stats)
    assert sum(isinstance(m, tlsq.DenseLSQ) for m in tmod.modules()) == 28
    _check_forward(fmod, tmod, params, stats, x_enc, x_dec, tol=tol, ratio=ratio)


def test_bf16_from_flax_params_are_the_f32_configs():
    """A bf16 config's flax params are f32, leaf for leaf the f32 config's
    (same init key), so ``from_flax`` gives the same f32 state_dict and the
    bf16 port model loads it with every tensor still f32."""
    _check_from_flax_params()


def _check_from_flax_params(dtype="bfloat16"):
    shapes = (jnp.zeros((1, SMALL["seq_len"], 16)),
              jnp.zeros((1, SMALL["label_len"] + SMALL["pred_len"], 16)))
    trees = [jax.jit(jax_build_informer(JaxInformerConfig(**SMALL, dtype=dt)).init)(
        jax.random.key(0), *shapes) for dt in ("float32", dtype)]
    f32, bf16 = (from_flax(jax.tree.map(np.asarray, t["params"]),
                           jax.tree.map(np.asarray, t["batch_stats"])) for t in trees)
    assert f32.keys() == bf16.keys()
    assert all(torch.equal(v, f32[k]) and v.dtype == f32[k].dtype for k, v in bf16.items())
    model = build_informer(InformerConfig(**SMALL, dtype=dtype), device="cpu")
    load_flax(model, jax.tree.map(np.asarray, trees[1]["params"]),
              jax.tree.map(np.asarray, trees[1]["batch_stats"]))
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) and sd[k].dtype == v.dtype for k, v in bf16.items())
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())


@pytest.mark.parametrize("grouped", [True, False])
def test_bf16_ptq_weights_match_jax_exactly(grouped):
    """``apply_weight_quant`` on a bf16 model quantizes its f32 params: the
    JAX package's quantized params exactly, grouped (one
    ``FixedPointWeightQuant``) or tensor by tensor; the quantized bf16
    models agree on a forward."""
    _check_ptq_weights(grouped)


def _check_ptq_weights(grouped, dtype="bfloat16", tol=MODEL_TOL, ratio=F32_RATIO, cfg=SMALL,
                       n_settings=44):
    wl, fl = 8, 4
    rng = np.random.default_rng(39)
    fmod, tmod, params, stats, x_enc, x_dec = _bf16_model_pair(rng, 3, dtype=dtype, **cfg)
    jset = jq_settings.build_weight_quant_settings(
        params, lambda w, p, k: jq.fixed_point_quantize(w, wl, fl, rounding="nearest", key=k))
    jparams = jq.apply_weight_quant(params, jset, key=jax.random.key(0))
    want = from_flax(jax.tree.map(np.asarray, jparams), stats)
    sd = tmod.state_dict()
    fn = (tq.FixedPointWeightQuant(wl, fl) if grouped else
          lambda w, p, g: tq.fixed_point_quantize(w, wl, fl, rounding="nearest", generator=g))
    got = tq.apply_weight_quant(sd, tq.build_weight_quant_settings(sd, fn))
    assert got.keys() == want.keys() and len(jset.settings) == n_settings  # SMALL: 4 x 6 + 2 x 10
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    tmod.load_state_dict(got)
    _check_forward(fmod, tmod, jparams, stats, x_enc, x_dec, tol=tol, ratio=ratio)


def test_bf16_metrics_promote_as_jax():
    """``nmse(pred_bf16, y_f32)`` promotes to f32; ``nmse_split``'s power
    term is a bf16 sum (f32 accumulation, rounded to bf16), its result f32."""
    _check_metrics_promote()


def _check_metrics_promote(dtype="bfloat16"):
    rng = np.random.default_rng(40)
    pred = rng.normal(size=(64, 5, 16)).astype(np.float32)
    target = (pred + 0.3 * rng.normal(size=pred.shape)).astype(np.float32)
    tp, jp = _bf16_pair(pred, dtype)
    for port_fn, jax_fn in ((nmse, jax_nmse), (nmse_split, jax_nmse_split)):
        got = port_fn(tp, torch.from_numpy(target))
        want = jax.jit(jax_fn)(jp, jnp.asarray(target))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_bf16_eval_step_matches_eval_step_impl():
    """The port's eval_step on JAX's draws, injected, against eval_step_impl
    in bf16: the batch stays f32, the model casts."""
    _check_eval_step()


def _check_eval_step(dtype="bfloat16", rtol=2e-2, cfg=SMALL):
    rng = np.random.default_rng(41)
    fmod, tmod, params, stats, _, _ = _bf16_model_pair(rng, 2, port_pallas=True, dtype=dtype,
                                                       **cfg)
    n, slots, feat, batch = 24, 40, 16, 8
    h = rng.normal(size=(n, slots, feat)).astype(np.float32)
    seq_len, pred_len, label_len = cfg["seq_len"], cfg["pred_len"], cfg["label_len"]
    state = types.SimpleNamespace(apply_fn=fmod.apply, params=params, batch_stats=stats)
    step_rng = jax.random.key(12)
    want = jax.jit(lambda h_, key: eval_step_impl(
        state, h_, key, batch_size=batch, label_len=label_len, seq_len=seq_len,
        pred_len=pred_len, snr_db=15.0))(jnp.asarray(h), step_rng)
    k_data, _ = jax.random.split(step_rng)
    k_idx, k_start, k_noise = jax.random.split(k_data, 3)
    draws = dict(
        idx=np.array(jax.random.randint(k_idx, (batch,), 0, n)),
        starts=np.array(jax.random.randint(k_start, (batch,), 0,
                                           slots - seq_len - pred_len + 1)),
        noise=np.array(jax.random.normal(k_noise, (batch, slots, feat))),
    )
    ds = WindowDataset(h=h, seq_len=seq_len, pred_len=pred_len, snr_db=15.0, device="cpu")
    got = eval_step(tmod, ds, batch_size=batch, label_len=label_len, **draws)
    assert got["nmse"].dtype == got["split"].dtype == torch.float32
    np.testing.assert_allclose(got["nmse"].numpy(), np.asarray(want["nmse"]), rtol=rtol)
    np.testing.assert_allclose(got["split"].numpy(), np.asarray(want["split"]), rtol=rtol)


# --- training ----------------------------------------------------------------

def _jax_grads(fmod, params, stats, batch):
    """``_update``'s gradients (through the recording optimizer), its
    metrics, its BatchNorm statistics and its train-mode output."""
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=_grad_recorder())
    key = jax.random.key(0)
    new_state, metrics = jax.jit(jax_update)(state, *batch, key, key)
    out, _ = jax_apply(state, params, stats, *batch[:2], train=True,
                       rngs={"dropout": key, "sample": key})
    return from_flax(jax.tree.map(np.asarray, new_state.opt_state),
                     jax.tree.map(np.asarray, new_state.batch_stats)), metrics, out


def _port_grads(model, x_enc, x_dec, target):
    model.train()
    pred = model(torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                 generator=torch.Generator().manual_seed(0))
    loss = nmse(pred, torch.from_numpy(target))
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}, pred, loss


def _grad_errors(got, want, floor):
    """Each gradient's max abs error over its own max abs (at least ``floor``)."""
    return {n: (g - want[n]).abs().max().item() / max(want[n].abs().max().item(), floor)
            for n, g in got.items()}


def _bf16_train_step(cfg, *, jax_pallas, port_pallas, seed, dtype="bfloat16",
                     tols=(MODEL_TOL, 2e-2, GRAD_TOL, GRAD_FLOOR, GRAD_RATIO)):
    """One training step in ``dtype`` (bf16 by default) at dropout 0, batch
    3, against JAX ``_update`` on the same batch: output, loss, split,
    BatchNorm statistics and every gradient, and each side's gradients
    against its own f32 model's; then one Adam update on the port, whose
    params and state stay f32. ``tols``: the model's (max relative error,
    NMSE), the loss's and statistics' relative tolerance, and
    ``GRAD_TOL``, ``GRAD_FLOOR``, ``GRAD_RATIO``'s values."""
    model_tol, rel, grad_tol, grad_floor, grad_ratio = tols
    rng = np.random.default_rng(seed)
    fmod, tmod, params, stats, x_enc, x_dec = _bf16_model_pair(
        rng, 3, jax_pallas=jax_pallas, port_pallas=port_pallas, dtype=dtype, **cfg)
    target = rng.normal(size=(3, cfg["pred_len"], 16)).astype(np.float32)
    batch = tuple(map(jnp.asarray, (x_enc, x_dec, target)))
    want, metrics, want_out = _jax_grads(fmod, params, stats, batch)
    f32_cfg = dataclasses.replace(fmod.config, dtype="float32")
    want_f32 = _jax_grads(fmod.clone(config=f32_cfg), params, stats, batch)[0]

    train_state = create_train_state(tmod, TrainConfig(lr=1e-3))
    grads, pred, loss = _port_grads(tmod, x_enc, x_dec, target)
    f32_model = build_informer(InformerConfig(use_pallas=port_pallas, **cfg), device="cpu")
    load_flax(f32_model, params, stats)
    grads_f32 = _port_grads(f32_model, x_enc, x_dec, target)[0]

    assert pred.dtype == getattr(torch, dtype) and loss.dtype == torch.float32
    assert _rel_err(pred, want_out) <= model_tol[0] and _nmse(pred, want_out) <= model_tol[1]
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=rel)
    np.testing.assert_allclose(nmse_split(pred.detach(), torch.from_numpy(target)).numpy(),
                               np.asarray(metrics["loss_split"]), rtol=rel)
    got_state = tmod.state_dict()
    for name in (k for k in want if "running_" in k):
        assert got_state[name].dtype == torch.float32
        np.testing.assert_allclose(got_state[name].numpy(), want[name].numpy(), rtol=rel,
                                   atol=1e-3, err_msg=name)
    assert all(g.dtype == torch.float32 for g in grads.values())
    floor = grad_floor * max(want_f32[n].abs().max().item() for n in grads)
    errs = _grad_errors(grads, want, floor)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_tol, (worst, errs[worst])
    port_vs_f32 = max(_grad_errors(grads, grads_f32, floor).values())
    jax_vs_f32 = max(_grad_errors({n: want[n] for n in grads}, want_f32, floor).values())
    assert port_vs_f32 <= grad_ratio * jax_vs_f32, (port_vs_f32, jax_vs_f32)

    apply_gradients(train_state)
    for p in tmod.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
        opt = train_state.optimizer.state[p]
        assert opt["exp_avg"].dtype == opt["exp_avg_sq"].dtype == torch.float32
    return errs


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_train_step_matches_jax_update(use_pallas):
    """The small config in bf16. With use_pallas the JAX side differentiates
    through the bd Pallas kernels in interpret mode and the port through its
    kernels' wrapper (the plain versions on the CPU)."""
    errs = _bf16_train_step(SMALL, jax_pallas=use_pallas, port_pallas=use_pallas, seed=42)
    assert len(errs) == len(list(build_informer(
        InformerConfig(**SMALL), device="cpu").parameters()))
