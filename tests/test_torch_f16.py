"""The port in float16 (``InformerConfig(dtype="float16")``) against the JAX
package's float16 models on the CPU, with shared weights.

float16 follows bf16's template (``tests/test_torch_bf16.py``, whose helpers
these tests call with ``dtype="float16"``): flax runs ``dtype`` as
"parameters f32, compute in dtype", LayerNorm and BatchNorm take their
statistics in f32 and round the result, LSQ quantizes the f32 weight and
casts it; the attention kernels (here their plain versions) compute in f32
and round once. The JAX package has no loss scaling, and the port adds
none. f16 keeps 11 significant bits to bf16's 8, so the bars are tighter
than bf16's, by about the ratio of their roundings. Errors are
``max|port - jax| / max|jax|``:

- one module (embedding, ConvLayer in eval and train mode, encoder and
  decoder layers pre- and post-norm, ``DenseLSQ``): <= 4e-3;
- a whole model (the small InformerStack on the plain and kernel routes,
  its prob and fused variants, LSQ-fibbinary, PTQ weights, the flagship
  width): <= 1e-2, and NMSE(port, jax) <= 2e-5; the long-wide shape that
  routes to mha: <= 2e-2 and NMSE <= 6e-5 (mha's plain version computes in
  f32 and rounds once, JAX's CPU route is XLA attention in f16);
- every whole model is also held to the f32 model with the same weights:
  NMSE(port f16, f32) <= 1.5 x NMSE(jax f16, f32);
- one training step: each gradient within 1e-1 of its own max abs (floor
  1e-2 of the largest gradient's), and the port's worst gradient error
  against its own f32 gradients at most 1.5 x JAX's against JAX's.
  BatchNorm statistics and the loss within 2e-2 relative, as bf16's.

Three bars start looser than the rest, each with its measured value (and
none past the bf16 file's):

- the flagship width, (2e-2, 6e-5) as the long-wide shape: 13 layers of
  f16 rounding on each side put the port 9.7e-3 and NMSE 3.0e-5 from JAX,
  while the port stands 3.6e-5 from the f32 model and JAX 5.7e-5;
- a gradient, 1e-1 of its max (3e-2 to start): the first encoder's distil
  conv weight sits 6.0e-2 from JAX's and its query weight 5.1e-2. The
  distil conv's max pooling routes its gradient through each window's
  maximum, which f16 values tie or nearly tie more often, and the two
  frameworks round them differently; both sides stand as far from their
  own f32 gradients (0.2225 and 0.2231 at that weight);
- int8 serving: W8A8 (5e-2, 1e-3), bf16's bars, and weight-only (2e-2,
  6e-5). W8A8 rounds each served layer's activations to 127 steps of their
  max, so f16's differences between the two sides (~2^-11) flip codes:
  measured 4.1e-2 and NMSE 6.7e-4, where serving itself moves each side's
  prediction by NMSE 1.3e-3; weight-only rounds them to bf16 for its MACs:
  7.9e-3 and 3.5e-5. Each side's served prediction is as far from its
  unserved f16 model as the other's (ratio 1.5).

Exact: the parameters, BatchNorm statistics, gradients and Adam state stay
f32; PTQ weights equal JAX's; ``from_flax`` of a float16 config's params is
that of the f32 config's; ``dtype="half"`` is float16 and ``"float64"``
runs as float32, bit for bit, as JAX runs them with x64 off.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core import config as jconfig
from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.transformer import Transformer as JaxTransformer
from channelestimationtransformer_tpu.ops.quant import serving as js

from channelestimationtransformer_torch.core import config as tconfig
from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models import build_transformer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.ops.quant import serving as ts
from channelestimationtransformer_torch.utils import convert
from channelestimationtransformer_torch.utils.convert import load_flax

from test_torch_baselines import TCFG
from test_torch_bf16 import (
    _apply,
    _bf16_model_pair,
    _bf16_train_step,
    _check_convlayer,
    _check_data_embedding,
    _check_decoder_layer,
    _check_dense_lsq,
    _check_encoder_layer,
    _check_eval_step,
    _check_forward,
    _check_long_wide,
    _check_lsq_informer,
    _check_metrics_promote,
    _check_prob_or_fused,
    _check_ptq_weights,
    _nmse,
    _rel_err,
    one_torch_thread,  # noqa: F401
)
from test_torch_informer import SMALL, _perturb

F16 = "float16"
MODULE_TOL = 4e-3  # max|port - jax| / max|jax|, one module
MODEL_TOL = (1e-2, 2e-5)  # the same over a whole model, and NMSE(port, jax)
MHA_TOL = (2e-2, 6e-5)  # the long-wide shape (module docstring)
F32_RATIO = 1.5  # NMSE(port f16, f32) over NMSE(jax f16, f32), at most
GRAD_TOL, GRAD_FLOOR, GRAD_RATIO = 1e-1, 1e-2, 1.5  # one training step (module docstring)
FLAGSHIP_TOL = (2e-2, 6e-5)  # the flagship width (module docstring)
INT8_TOL = {"w8a8": (5e-2, 1e-3), "weight_only": (2e-2, 6e-5)}  # (module docstring)
STEP_TOLS = (MODEL_TOL, 2e-2, GRAD_TOL, GRAD_FLOOR, GRAD_RATIO)
MODEL = dict(tol=MODEL_TOL, ratio=F32_RATIO)
# The small stack with one encoder layer and one decoder layer fewer (a
# distil conv still in encoder 0): every whole-model case but the prob,
# fused and LSQ ones, which keep their files' configs.
TINY = dict(SMALL, e_layers=(2, 1), d_layers=1)


# --- modules -----------------------------------------------------------------

@pytest.mark.parametrize("module", ["embedding", "conv eval", "conv train", "encoder post",
                                    "encoder pre", "decoder post", "decoder pre",
                                    "decoder no mix", "dense lsq"])
def test_f16_module_matches_flax(module):
    """Each module in float16 against flax's float16 module (``MODULE_TOL``;
    ConvLayer's train mode also updates its f32 running statistics as
    flax's)."""
    check = {"embedding": lambda: _check_data_embedding(F16, MODULE_TOL),
             "conv eval": lambda: _check_convlayer(False, F16, MODULE_TOL),
             "conv train": lambda: _check_convlayer(True, F16, MODULE_TOL),
             "encoder post": lambda: _check_encoder_layer(False, F16, MODULE_TOL),
             "encoder pre": lambda: _check_encoder_layer(True, F16, MODULE_TOL),
             "decoder post": lambda: _check_decoder_layer(True, False, F16, MODULE_TOL),
             "decoder pre": lambda: _check_decoder_layer(True, True, F16, MODULE_TOL),
             "decoder no mix": lambda: _check_decoder_layer(False, False, F16, MODULE_TOL),
             "dense lsq": lambda: _check_dense_lsq(True, F16, MODULE_TOL)}
    check[module]()


# --- whole models ------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_f16_informer_stack_matches_flax(use_pallas):
    """The small InformerStack in float16. With use_pallas the JAX side runs
    the bd Pallas kernel in interpret mode (f32 inside, f16 out) and the
    port its kernel's wrapper (its plain version on the CPU, the same
    rounding); without, both run their plain attention in f16."""
    rng = np.random.default_rng(35)
    _check_forward(*_bf16_model_pair(rng, 3, jax_pallas=use_pallas, port_pallas=use_pallas,
                                     dtype=F16, **TINY), **MODEL)


@pytest.mark.parametrize("name", ["prob", "fused"])
def test_f16_prob_and_fused_stacks_match_flax(name, monkeypatch, one_torch_thread):
    """The small prob stack (JAX's ``index_sample`` draws injected) and the
    small fused one in float16 on the kernel route (JAX's draws recorded
    from its f32 prob model, the same key's)."""
    _check_prob_or_fused(name, True, monkeypatch, F16, **MODEL, f32_draws=True)


def test_f16_lsq_fibbinary_informer_matches_flax():
    """LSQ-fibbinary in float16, eval, use_pallas on both sides."""
    _check_lsq_informer(True, F16, **MODEL)


def test_f16_ptq_weights_match_jax_exactly():
    """``apply_weight_quant`` (one grouped ``FixedPointWeightQuant``) on a
    float16 model quantizes its f32 params to JAX's exactly, and the
    quantized models agree."""
    _check_ptq_weights(True, F16, **MODEL, cfg=TINY, n_settings=3 * 6 + 1 * 10)


def test_f16_flagship_width_forward_matches_flax():
    """``InformerConfig(use_pallas=True, dtype="float16")`` at the flagship
    width, batch 2: the port's kernel route against the JAX package's XLA
    path."""
    rng = np.random.default_rng(36)
    _check_forward(*_bf16_model_pair(rng, 2, port_pallas=True, dtype=F16), tol=FLAGSHIP_TOL,
                   ratio=F32_RATIO)


def test_f16_long_wide_eval_forward_goes_through_mha_attention(monkeypatch):
    """seq_len 160, E 128 in float16 with use_pallas: every attention call
    reaches mha_attention with f16 q, k, v, against flax's XLA attention in
    f16."""
    _check_long_wide(monkeypatch, F16, MHA_TOL, F32_RATIO)


def test_f16_eval_step_and_metrics_match_jax():
    """The port's eval_step on JAX's draws against eval_step_impl in float16
    (the batch stays f32, the model casts), and ``nmse`` / ``nmse_split`` of
    an f16 prediction promote as JAX's do."""
    _check_eval_step(F16, rtol=2e-3, cfg=TINY)
    _check_metrics_promote(F16)


def test_f16_train_step_matches_jax_update():
    """One step of a small stack in float16 at dropout 0 through the kernels'
    wrappers (their plain versions on the CPU) against JAX ``_update``
    through the bd Pallas kernels in interpret mode: output, loss,
    BatchNorm statistics and every gradient, each side against its own f32
    gradients; params and Adam state stay f32."""
    _bf16_train_step(TINY, jax_pallas=False, port_pallas=True, seed=42, dtype=F16,
                     tols=STEP_TOLS)


def test_f16_transformer_baseline_matches_flax():
    """``TransformerConfig(dtype="float16")`` against flax's float16
    Transformer: f16 out, ``MODEL_TOL``, and as close to the f32 model as
    flax's f16 is."""
    rng = np.random.default_rng(43)
    fmod = JaxTransformer(config=jconfig.TransformerConfig(**TCFG, dtype=F16))
    x_enc = rng.normal(size=(3, TCFG["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(3, TCFG["label_len"] + TCFG["pred_len"], 16)).astype(np.float32)
    inputs = jnp.asarray(x_enc), jnp.asarray(x_dec)
    params = _perturb(jax.jit(fmod.init)(jax.random.key(0), *inputs)["params"], rng)
    tmod = build_transformer(tconfig.TransformerConfig(**TCFG, dtype=F16), device="cpu")
    convert.load_flax_transformer(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    want = _apply(fmod, params, {}, *inputs)
    f32 = _apply(fmod.clone(config=dataclasses.replace(fmod.config, dtype="float32")), params,
                 {}, *inputs)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    assert _rel_err(got, want) <= MODEL_TOL[0] and _nmse(got, want) <= MODEL_TOL[1]
    assert _nmse(got, f32) <= F32_RATIO * _nmse(want, f32)


@pytest.fixture(scope="module")
def small_f16():
    """The small InformerStack pair in float16 (batch 4: past the int8
    GEMM's m > 16), flax's variables."""
    fmod, tmod, params, stats, x_enc, x_dec = _bf16_model_pair(
        np.random.default_rng(44), 4, dtype=F16, **TINY)
    return fmod, tmod, {"params": params, "batch_stats": stats}, x_enc, x_dec


@pytest.mark.parametrize("mode", ["w8a8", "weight_only"])
def test_f16_int8_serving_matches_jax(small_f16, mode):
    """int8 serving of a float16 model: the table is the f32 params' (as
    JAX's); W8A8 quantizes f16 activations, weight-only keeps bf16 MACs as
    JAX's ``serving.py:133`` does; each served layer's output is in x's
    dtype, so the prediction is f16, within ``INT8_TOL`` of JAX's intercept,
    as far from the unserved f16 model as JAX's (``F32_RATIO``), and not the
    unserved forward."""
    fmod, tmod, variables, x_enc, x_dec = small_f16
    jtable = js.build_int8_table(variables)

    def served(v, a, b):
        with js.serving_intercept(jtable, mode=mode):
            return fmod.apply(v, a, b)
    want = jax.jit(served)(variables, jnp.asarray(x_enc), jnp.asarray(x_dec))
    got = ts.predict_int8(tmod, torch.from_numpy(x_enc), torch.from_numpy(x_dec), mode=mode)
    with torch.no_grad():
        unserved = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    jax_unserved = _apply(fmod, variables["params"], variables["batch_stats"],
                          jnp.asarray(x_enc), jnp.asarray(x_dec))
    tol = INT8_TOL[mode]
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    assert _rel_err(got, want) <= tol[0] and _nmse(got, want) <= tol[1]
    assert _nmse(got, unserved) <= F32_RATIO * _nmse(want, jax_unserved)
    assert (got - unserved).abs().max() > 1e-2 * unserved.abs().max()


def test_half_and_float64_configs_run_as_jax_runs_them():
    """As JAX with x64 off runs them: its "float64" model equals its
    "float32" one bit for bit, and the port's "float64" model (built with a
    ``UserWarning``) equals the port's "float32" one and matches JAX's at
    the f32 tolerance; ``dtype="half"`` builds the port's float16 model.
    The flax params of a float16 and a float64 config are the f32 config's,
    leaf for leaf (same init key), so ``from_flax`` loads one state_dict
    into all."""
    cfg = dict(SMALL, e_layers=(1, 1), d_layers=1)
    rng = np.random.default_rng(45)
    x_enc = rng.normal(size=(2, SMALL["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(2, SMALL["label_len"] + SMALL["pred_len"], 16)).astype(np.float32)
    inputs = jnp.asarray(x_enc), jnp.asarray(x_dec)
    fmods = {dt: jax_build_informer(JaxInformerConfig(**cfg, dtype=dt))
             for dt in ("float32", "float64", "float16")}
    trees = {dt: jax.jit(m.init)(jax.random.key(0), *inputs) for dt, m in fmods.items()}
    for dt in ("float64", "float16"):
        assert jax.tree.all(jax.tree.map(lambda a, b: a.dtype == b.dtype == jnp.float32
                                         and bool((a == b).all()), trees[dt], trees["float32"]))
    v = trees["float32"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX warns where it narrows float64
        outs = {dt: _apply(fmods[dt], v["params"], v.get("batch_stats", {}), *inputs)
                for dt in ("float32", "float64")}
    assert outs["float64"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(outs["float64"]), np.asarray(outs["float32"]))
    models, got = {}, {}
    for dt in ("float32", "float64", "float16", "half"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            models[dt] = build_informer(InformerConfig(**cfg, dtype=dt), device="cpu", seed=0)
        assert [w.category for w in caught] == ([UserWarning] if dt == "float64" else [])
        load_flax(models[dt], v["params"], v.get("batch_stats", {}))
        with torch.no_grad():
            got[dt] = models[dt](torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    assert got["float64"].dtype == torch.float32 and torch.equal(got["float64"], got["float32"])
    assert got["half"].dtype == torch.float16 and torch.equal(got["half"], got["float16"])
    np.testing.assert_allclose(got["float64"].numpy(), np.asarray(outs["float64"]), rtol=1e-4,
                               atol=1e-5)
