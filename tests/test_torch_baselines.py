"""The baseline models in the port against the JAX package's
(``models/transformer.py``, ``models/recurrent.py``), with shared weights
through the bridge (``utils/convert.py``), on the CPU.

- The configs: ``TransformerConfig``, ``RecurrentConfig`` and
  ``full_precision_config`` with JAX's fields and defaults.
- The Transformer in eval against flax at atol 1e-5, and one training step
  at dropout 0 against JAX ``_update`` (output, loss, every gradient), as
  ``tests/test_torch_training.py`` holds the Informer's.
- ``RecurrentPredictor.forward`` (teacher-forced) and ``rollout``
  (closed loop) for lstm, gru and rnn at atol 1e-5, and one Adam step of
  the comparison driver's recurrent training (lr 1e-3, the last 10 slots'
  NMSE) against optax: the moments at the gradient tolerance, the
  parameters within 2e-6 (0.2% of the step).
- ``from_flax_transformer`` / ``from_flax_recurrent``: strict both ways.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from channelestimationtransformer_tpu.core import config as jconfig
from channelestimationtransformer_tpu.core.metrics import nmse as jax_nmse
from channelestimationtransformer_tpu.models.recurrent import RecurrentPredictor as JaxRecurrent
from channelestimationtransformer_tpu.models.transformer import Transformer as JaxTransformer
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _apply as jax_apply
from channelestimationtransformer_tpu.train.trainer import _update as jax_update

from channelestimationtransformer_torch.core import config as tconfig
from channelestimationtransformer_torch.core.metrics import nmse, nmse_split
from channelestimationtransformer_torch.models import (
    RecurrentPredictor,
    Transformer,
    build_recurrent,
    build_transformer,
)
from channelestimationtransformer_torch.utils import convert

from test_torch_informer import _perturb
from test_torch_training import _grad_recorder, _np

ATOL = 1e-5
RTOL, GRAD_ATOL = 2e-4, 2e-5  # gradients: the training tests' tolerance
TCFG = dict(seq_len=20, label_len=6, pred_len=4, d_model=32, n_heads=4,
            num_encoder_layers=2, num_decoder_layers=2, d_ff=24, dropout=0.0)
RCFG = dict(features=16, input_size=24, hidden_size=32, num_layers=2)
CELLS = ["lstm", "gru", "rnn"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["TransformerConfig", "RecurrentConfig"])
def test_configs_have_jax_fields_and_defaults(name):
    want, got = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
        (f.name, f.default) for f in dataclasses.fields(want)]
    assert got.__dataclass_params__.frozen and got().dtype == "float32"
    with pytest.raises(TypeError):
        got(1)  # keyword-only
    assert [type(c).__name__ for c in tconfig.full_precision_config()] == [
        type(c).__name__ for c in jconfig.full_precision_config()]
    assert tconfig.full_precision_config()[0] == tconfig.InformerConfig()


def test_config_checks():
    """The cell is checked; ``dtype="float16"`` builds both baselines, whose
    outputs come out in JAX's dtypes: the Transformer's in float16, the
    recurrent model's in float32 (it computes in f32 whatever the dtype);
    their parameters stay f32."""
    with pytest.raises(ValueError, match="'rnn', 'gru' or 'lstm'"):
        tconfig.RecurrentConfig(cell="transformer")
    rng = np.random.default_rng(9)
    x_enc = rng.normal(size=(2, TCFG["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(2, TCFG["label_len"] + TCFG["pred_len"], 16)).astype(np.float32)
    cases = [(build_transformer(tconfig.TransformerConfig(**TCFG, dtype="float16"), device="cpu"),
              JaxTransformer(config=jconfig.TransformerConfig(**TCFG, dtype="float16")),
              (x_enc, x_dec)),
             (build_recurrent(tconfig.RecurrentConfig(**RCFG, dtype="float16"), device="cpu"),
              JaxRecurrent(config=jconfig.RecurrentConfig(**RCFG, dtype="float16")), (x_enc,))]
    for tmod, fmod, inputs in cases:
        with torch.no_grad():
            got = tmod(*map(torch.from_numpy, inputs))
        jx = tuple(map(jnp.asarray, inputs))
        want = jax.jit(fmod.apply)(jax.jit(fmod.init)(jax.random.key(0), *jx), *jx)
        assert str(got.dtype) == f"torch.{want.dtype}" and torch.isfinite(got).all()
        assert all(p.dtype == torch.float32 for p in tmod.parameters())


def _transformer_pair(rng, batch):
    fmod = JaxTransformer(config=jconfig.TransformerConfig(**TCFG))
    x_enc = rng.normal(size=(batch, TCFG["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(batch, TCFG["label_len"] + TCFG["pred_len"], 16)).astype(np.float32)
    v = jax.jit(fmod.init)(jax.random.key(0), jnp.asarray(x_enc), jnp.asarray(x_dec))
    params = _perturb(v["params"], rng)
    tmod = build_transformer(tconfig.TransformerConfig(**TCFG), device="cpu")
    convert.load_flax_transformer(tmod, params)
    return fmod, tmod, params, x_enc, x_dec


def test_transformer_matches_flax():
    rng = np.random.default_rng(0)
    fmod, tmod, params, x_enc, x_dec = _transformer_pair(rng, 3)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec)).numpy()
    want = np.asarray(jax.jit(fmod.apply)({"params": params}, jnp.asarray(x_enc),
                                          jnp.asarray(x_dec)))
    assert got.shape == (3, TCFG["pred_len"], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_transformer_train_step_matches_jax_update():
    """One step at dropout 0, batch 3: output, loss, split and every
    gradient against JAX ``_update`` (the ``Trainer``'s step) on the same
    batch; the port's model trains through the Informer's signature."""
    rng = np.random.default_rng(1)
    fmod, tmod, params, x_enc, x_dec = _transformer_pair(rng, 3)
    target = rng.normal(size=(3, TCFG["pred_len"], 16)).astype(np.float32)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats={},
                                 tx=_grad_recorder())
    key = jax.random.key(0)
    batch = tuple(map(jnp.asarray, (x_enc, x_dec, target)))
    new_state, metrics = jax.jit(jax_update)(state, *batch, key, key)
    want_out, _ = jax_apply(state, params, {}, *batch[:2], train=True,
                            rngs={"dropout": key, "sample": key})

    tmod.train()
    pred = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                generator=torch.Generator().manual_seed(0))
    loss = nmse(pred, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_out), rtol=RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    np.testing.assert_allclose(nmse_split(pred.detach(), torch.from_numpy(target)).numpy(),
                               np.asarray(metrics["loss_split"]), rtol=RTOL)
    want = convert.from_flax_transformer(_np(new_state.opt_state))
    names = [n for n, _ in tmod.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_transformer_train_mode_needs_a_generator():
    tmod = build_transformer(tconfig.TransformerConfig(**dict(TCFG, dropout=0.1)),
                             device="cpu").train()
    x_enc, x_dec = torch.randn(2, TCFG["seq_len"], 16), torch.randn(2, 10, 16)
    with pytest.raises(ValueError, match="Generator"):
        tmod(x_enc, x_dec)
    a, b = (tmod(x_enc, x_dec, generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b)


def _recurrent_pair(rng, cell, batch=3, length=14):
    cfg = dict(RCFG, cell=cell)
    fmod = JaxRecurrent(config=jconfig.RecurrentConfig(**cfg))
    x = rng.normal(size=(batch, length, 16)).astype(np.float32)
    params = _perturb(jax.jit(fmod.init)(jax.random.key(0), jnp.asarray(x))["params"], rng)
    tmod = build_recurrent(tconfig.RecurrentConfig(**cfg), device="cpu")
    convert.load_flax_recurrent(tmod, params)
    return fmod, tmod, params, x


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_forward_and_rollout_match_flax(cell):
    rng = np.random.default_rng(2)
    fmod, tmod, params, x = _recurrent_pair(rng, cell)
    variables = {"params": params}
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
        got_roll = tmod.rollout(torch.from_numpy(x), 5).numpy()
    want = np.asarray(jax.jit(fmod.apply)(variables, jnp.asarray(x)))
    want_roll = np.asarray(jax.jit(lambda v, a: fmod.apply(v, a, 5, method=JaxRecurrent.rollout))(
        variables, jnp.asarray(x)))
    assert got.shape == x.shape and got_roll.shape == (3, 5, 16)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_roll, want_roll, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_adam_step_matches_optax(cell):
    """``cli/comparison.py:train_recurrent``'s step: the last 10 slots'
    NMSE against the clean window, then one Adam step at lr 1e-3. Flax's
    parameters one for one (one bias where flax has one); Adam's moments
    (0.1 g and 0.001 g^2) hold the gradients at the training tests'
    tolerance, and each parameter moves by optax's step within 2e-6 (0.2%
    of the 1e-3 step: a gradient near Adam's eps 1e-8 that differs in its
    last bits moves ``g / (|g| + eps)`` by up to lr * |dg| / eps)."""
    rng = np.random.default_rng(3)
    fmod, tmod, params, noisy = _recurrent_pair(rng, cell, length=20)
    clean = rng.normal(size=noisy.shape).astype(np.float32)
    tx = optax.adam(1e-3)

    def loss_fn(p):
        return jax_nmse(fmod.apply({"params": p}, jnp.asarray(noisy))[:, -10:],
                        jnp.asarray(clean)[:, -10:])
    grads = jax.jit(jax.grad(loss_fn))(params)
    updates, opt = tx.update(grads, tx.init(params))
    want = convert.from_flax_recurrent(_np(optax.apply_updates(params, updates)))
    want_mu, want_nu = (convert.from_flax_recurrent(_np(m)) for m in (opt[0].mu, opt[0].nu))

    tmod.train()
    topt = torch.optim.Adam(tmod.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss = nmse(tmod(torch.from_numpy(noisy))[:, -10:], torch.from_numpy(clean)[:, -10:])
    loss.backward()
    topt.step()
    np.testing.assert_allclose(loss.item(), float(loss_fn(params)), rtol=RTOL)
    got = dict(tmod.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        m = topt.state[p]
        np.testing.assert_allclose(m["exp_avg"].numpy() / 0.1, want_mu[name].numpy() / 0.1,
                                   rtol=RTOL, atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(np.sqrt(m["exp_avg_sq"].numpy() / 1e-3),
                                   np.sqrt(want_nu[name].numpy() / 1e-3), rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["transformer", "lstm", "gru", "rnn"])
def test_bridge_is_strict_both_ways(which):
    """A flax leaf the walk does not use, or one it needs that is missing,
    raises; a state dict that leaves a port parameter unfilled (another
    model's) raises on load."""
    rng = np.random.default_rng(4)
    if which == "transformer":
        _, tmod, params, _, _ = _transformer_pair(rng, 2)
        fn, load = convert.from_flax_transformer, convert.load_flax_transformer
        other = build_transformer(tconfig.TransformerConfig(**dict(TCFG, num_decoder_layers=3)),
                                  device="cpu")
        drop = ("decoder_1", "ffn2")
    else:
        _, tmod, params, _ = _recurrent_pair(rng, which)
        fn, load = convert.from_flax_recurrent, convert.load_flax_recurrent
        other = build_recurrent(tconfig.RecurrentConfig(**dict(RCFG, cell=which, num_layers=3)),
                                device="cpu")
        drop = ("cells_1", "hn" if which == "gru" else ("hi" if which == "lstm" else "h"))
    params = _np(params)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        fn(extra)
    missing = jax.tree.map(lambda a: a, params)
    del missing[drop[0]][drop[1]]
    with pytest.raises(KeyError, match="lack the leaf"):
        fn(missing)
    with pytest.raises(RuntimeError, match="Missing key"):
        load(other, params)
    assert isinstance(tmod, Transformer if which == "transformer" else RecurrentPredictor)


# --- the comparison driver ---------------------------------------------------------------

def test_comparison_driver_flags_match_the_jax_driver():
    """Every flag of ``experiments/comparison.py`` (its own and
    ``add_channel_args``'s); the port adds ``--device``."""
    from channelestimationtransformer_torch.cli import comparison

    from test_torch_cli import _jax_flags, _port_flags

    want = _jax_flags("experiments/comparison.py")
    want.update({k: v for k, v in
                 _jax_flags("channelestimationtransformer_tpu/channel/cdl.py").items()
                 if k in ("--slot-symbols", "--ue-speed-kmh", "--calibrated")})
    got = _port_flags(comparison.build_parser())
    assert set(got) == set(want) | {"--device"}
    for flag in want:
        assert got[flag] == want[flag], flag


def test_comparison_driver_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """All five models, cut to 2 steps (recurrent) or one epoch of 2 steps
    at batch 16 (Trainer), datasets cut to 64 samples, two SNRs: the pickles
    and ``comparison.json`` in JAX's layout (SNR keys as given on the
    command line), five horizons a row, the lines JAX prints."""
    import json
    import pickle

    from channelestimationtransformer_torch.cli import comparison

    real_make, real_tc = comparison.make_window_dataset, comparison.TrainConfig
    monkeypatch.setattr(comparison, "make_window_dataset",
                        lambda key, **kw: real_make(key, **dict(kw, num_samples=64)))
    monkeypatch.setattr(comparison, "TrainConfig", lambda **kw: real_tc(
        **dict(kw, batch_size=16, steps_per_epoch=2)))
    steps = []
    real_train = comparison.train_recurrent
    monkeypatch.setattr(comparison, "train_recurrent",
                        lambda *a, **k: steps.append(a[2]) or real_train(*a, **k))
    out = tmp_path / "cmp"
    res = comparison.main(["--device", "cpu", "--steps", "2", "--epochs", "1",
                           "--snr-sweep", "12", "21", "--calibrated", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    models = ["rnn", "gru", "lstm", "transformer", "informer"]
    assert list(res) == models and steps == [2, 2, 2]
    for name in models:
        assert list(res[name]) == [12.0, 21.0]
        assert all(len(v) == 5 and np.isfinite(v).all() for v in res[name].values())
        with open(out / f"loss_{name}.pkl", "rb") as f:
            assert pickle.load(f) == res[name]
        assert f"=== {name} ===" in lines
    assert json.loads((out / "comparison.json").read_text()) == {
        m: {str(k): v for k, v in r.items()} for m, r in res.items()}
    assert lines[-1] == json.dumps({"sweep": "comparison", "models": models})
