"""LSQ training in the port against the JAX package's, on the CPU, and the
drivers that run it.

- ``ConvLSQ`` against flax's (kernel size 1 and 3, quantize on and off,
  fibbinary): output and the gradients of the weight and bias at rtol 2e-4
  / atol 2e-5 (float32, sums in another order); the step size's, a sum
  with a 1e4-fold cancellation, as ``tests/test_torch_lsq.py`` holds it.
- One LSQ-fibbinary (and LSQ) training step of a small InformerStack
  against JAX ``_update`` at dropout 0: loss, BatchNorm statistics and
  every gradient, ``step_size`` included, at the same tolerance.
- The FP32 -> LSQ preload (``train/checkpoint.py:load_weights_overlay``):
  every name the checkpoint holds is replaced, and each ``step_size`` keeps
  the value of the LSQ model's own initial weights.
- ``cli/train_lsq.py``: its flags against ``experiments/train_lsq.py``'s
  source (plus ``--device`` and ``--use-pallas``), and its results file
  merged with the committed artifact and an earlier file, written after
  every nbits. ``cli/sweep.py``: ``SWEEPS`` equal to
  ``experiments/sweep.py``'s, and unknown flags forwarded in order.
  ``cli/train_informer.py --attn prob`` runs and names its run ``_at_prob_``.
"""

import functools
import importlib.util
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.ops.quant import codebooks as jcb
from channelestimationtransformer_tpu.ops.quant import lsq as jlsq
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update

from channelestimationtransformer_torch.cli import sweep, train_informer, train_lsq
from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.core.metrics import nmse
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.models.informer_lsq import build_informer_lsq
from channelestimationtransformer_torch.ops.quant import ConvLSQ, DenseLSQ, lsq_step_size_init
from channelestimationtransformer_torch.train.checkpoint import (
    load_weights_overlay,
    save_checkpoint,
)
from channelestimationtransformer_torch.train.trainer import create_train_state
from channelestimationtransformer_torch.utils.convert import from_flax, load_flax

from test_torch_cli import ROOT, SMALL as CLI_SMALL, _jax_flags, _port_flags, jax_run_name
from test_torch_lsq import SMALL, _lsq_pair
from test_torch_training import _grad_recorder, _np

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("kernel_size,quantize,fibbinary", [
    (1, False, False), (3, False, False), (1, True, False), (3, True, False),
    (1, True, True), (3, True, True)])
def test_conv_lsq_matches_flax(kernel_size, quantize, fibbinary):
    rng = np.random.default_rng(kernel_size + 2 * quantize + 4 * fibbinary)
    x = rng.normal(size=(2, 23, 24)).astype(np.float32)
    ct = rng.normal(size=(2, 23, 32)).astype(np.float32)
    fmod = jlsq.ConvLSQ(32, kernel_size=kernel_size, nbits=8, quantize=quantize,
                        fibbinary=fibbinary)
    params = jax.tree.map(np.array, fmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    params["bias"] = (0.1 * rng.normal(size=32)).astype(np.float32)
    if quantize:
        params["step_size"] = np.float32(params["step_size"] * 0.7)

    def loss_of(module):
        return lambda p, x_: jnp.sum(module.apply({"params": p}, x_) * ct)
    want = np.asarray(fmod.apply({"params": params}, jnp.asarray(x)))
    want_grads = jax.grad(loss_of(fmod))(params, jnp.asarray(x))

    tmod = ConvLSQ(24, 32, kernel_size, nbits=8, quantize=quantize, fibbinary=fibbinary)
    sd = {"weight": torch.from_numpy(params["kernel"]).permute(2, 1, 0).contiguous(),
          "bias": torch.from_numpy(params["bias"])}
    if quantize:
        sd["step_size"] = torch.tensor(params["step_size"])
    tmod.load_state_dict(sd, strict=True)
    got = tmod(torch.from_numpy(x))
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod.weight.grad.permute(2, 1, 0).numpy(),
                               np.asarray(want_grads["kernel"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod.bias.grad.numpy(), np.asarray(want_grads["bias"]),
                               rtol=RTOL, atol=ATOL)
    if quantize:
        # d/ds sums over every weight with cancelling signs (a 1e4-fold
        # cancellation here), taken in another order: beside rtol 1e-5, 1e-7
        # of the sum of its terms' magnitudes, g * |dL/dw_q| * (|w_q / s| +
        # |w / s|), as tests/test_torch_lsq.py allows. The conv is linear in
        # its weight, so dL/dw_q is the unquantized layer's weight gradient.
        plain = jlsq.ConvLSQ(32, kernel_size=kernel_size)
        cot = np.asarray(jax.grad(loss_of(plain))(
            {"kernel": params["kernel"], "bias": params["bias"]}, jnp.asarray(x))["kernel"])
        w, step = params["kernel"], params["step_size"]
        qp = 2 ** 7 - 1
        w_q = np.asarray(jlsq.lsq_quantize(jnp.asarray(w), jnp.asarray(step), 8,
                                           jcb.lsq_fibbinary_codebook(8) if fibbinary else None))
        terms = np.sum(np.abs(cot) * (np.abs(w_q / step) + np.minimum(np.abs(w / step), qp + 1)))
        terms /= np.sqrt(w.size * qp)
        np.testing.assert_allclose(tmod.step_size.grad.numpy(),
                                   np.asarray(want_grads["step_size"]), rtol=1e-5,
                                   atol=1e-7 * terms)
    else:
        assert not hasattr(tmod, "step_size")


def test_conv_lsq_step_size_starts_from_its_weight():
    m = ConvLSQ(16, 8, 3, nbits=6, quantize=True)
    assert m.weight.shape == (8, 16, 3)
    assert torch.equal(m.step_size.detach(), lsq_step_size_init(m.weight.detach(), 6))


@pytest.mark.parametrize("fibbinary,use_pallas", [(True, True), (True, False), (False, False)])
def test_lsq_train_step_matches_jax_update(fibbinary, use_pallas):
    """One training step of the small LSQ InformerStack (weights and step
    sizes perturbed, from flax through from_flax) against JAX ``_update``;
    with use_pallas the port's snap and attention take their kernels'
    wrappers (plain versions on the CPU)."""
    rng = np.random.default_rng(40 + fibbinary)
    jcfg, fmod, params, stats, x_enc, x_dec = _lsq_pair(rng, fibbinary)
    target = rng.normal(size=(3, jcfg.pred_len, 16)).astype(np.float32)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=_grad_recorder())
    key = jax.random.key(0)
    new_state, metrics = jax.jit(jax_update)(
        state, *map(jnp.asarray, (x_enc, x_dec, target)), key, key)

    model = build_informer_lsq(InformerConfig(use_pallas=use_pallas, **SMALL), nbits=8,
                               fibbinary=fibbinary, device="cpu")
    load_flax(model, params, stats)
    model.train()
    pred = model(torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                 generator=torch.Generator().manual_seed(0))
    loss = nmse(pred, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    want = from_flax(_np(new_state.opt_state), _np(new_state.batch_stats))
    got_state = model.state_dict()
    for name in [k for k in want if "running_" in k]:
        np.testing.assert_allclose(got_state[name].numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    steps = [n for n, _ in model.named_parameters() if n.endswith("step_size")]
    assert len(steps) == 28
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


SMALL_CFG = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=16)


def _fp32_checkpoint(tmp_path, cfg):
    """An FP32 checkpoint of ``cfg`` with weights from seed 1 and BatchNorm
    statistics away from their init."""
    fp32 = build_informer(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for name, b in fp32.named_buffers():
            if "running_" in name:
                b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    return fp32, save_checkpoint(create_train_state(fp32, TrainConfig()), str(tmp_path),
                                 "fp32_", 3)


def test_fp32_preload_replaces_weights_and_keeps_the_init_step_sizes(tmp_path):
    cfg = InformerConfig(**SMALL_CFG)
    fp32, path = _fp32_checkpoint(tmp_path, cfg)
    model = build_informer_lsq(cfg, nbits=8, fibbinary=True, device="cpu", seed=0)
    layers = {n: m for n, m in model.named_modules() if isinstance(m, DenseLSQ)}
    init = {n: (m.weight.detach().clone(), m.step_size.detach().clone())
            for n, m in layers.items()}
    names = load_weights_overlay(path, model)
    assert names == sorted(fp32.state_dict())
    got = model.state_dict()
    for name, value in fp32.state_dict().items():
        assert torch.equal(got[name], value), name
    assert len(layers) == 28
    for n, m in layers.items():
        w0, s0 = init[n]
        assert torch.equal(m.step_size.detach(), s0)
        assert torch.equal(s0, lsq_step_size_init(w0, 8))
        assert not torch.equal(m.weight.detach(), w0)
        assert not torch.allclose(m.step_size.detach(), lsq_step_size_init(m.weight.detach(), 8))


def test_train_lsq_flags_match_the_jax_driver():
    """Every flag of ``experiments/train_lsq.py`` (its own and those of
    ``add_channel_args``) with its default, type, choices and nargs; the
    port adds ``--device`` and ``--use-pallas``."""
    want = _jax_flags("experiments/train_lsq.py")
    channel = {k: v for k, v in
               _jax_flags("channelestimationtransformer_tpu/channel/cdl.py").items()
               if k in ("--slot-symbols", "--ue-speed-kmh", "--calibrated")}
    assert len(channel) == 3
    want.update(channel)
    got = _port_flags(train_lsq.build_parser())
    assert set(got) == set(want) | {"--device", "--use-pallas"}
    for flag in want:
        assert got[flag] == want[flag], flag
    assert got["--device"]["default"] is None and got["--use-pallas"]["default"] is False


def test_train_lsq_writes_merged_results_after_every_nbits(tmp_path, monkeypatch, capsys):
    """Two nbits on a shrunken model: each row written with its preload's
    name, merged over the committed artifact and an earlier file in --out;
    a checkpoint per nbits."""
    monkeypatch.setattr(train_lsq, "InformerConfig",
                        functools.partial(InformerConfig, **SMALL_CFG))
    _, ckpt = _fp32_checkpoint(tmp_path, InformerConfig(**SMALL_CFG))
    out = tmp_path / "out"
    out.mkdir()
    earlier = {"lsqfib_n99": {"nbits": 99, "final_val_nmse": 1.0}}
    (out / "lsq_fibbinary_results.json").write_text(json.dumps(earlier))
    artifact = json.loads((ROOT / "experiments/artifacts/lsq_fibbinary_results.json").read_text())

    results = train_lsq.main(["--device", "cpu", "--fibbinary", "--nbits-min", "7",
                              "--nbits-max", "8", "--epochs", "1", "--steps-per-epoch", "1",
                              "--train-samples", "64", "--calibrated", "--checkpoint", ckpt,
                              "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines.count(f"Preloaded FP32 weights from {ckpt}") == 2
    on_disk = json.loads((out / "lsq_fibbinary_results.json").read_text())
    assert on_disk == results
    assert set(on_disk) == set(artifact) | set(earlier) | {"lsqfib_n7", "lsqfib_n8"}
    assert on_disk["lsqfib_n99"] == earlier["lsqfib_n99"]
    for nbits in (7, 8):
        row = on_disk[f"lsqfib_n{nbits}"]
        assert row["nbits"] == nbits and row["preload"] == "fp32_3.pt"
        assert np.isfinite(row["final_val_nmse"]) and len(row["final_val_split"]) == 5
        assert json.loads([x for x in lines if x.startswith('{"nbits": %d' % nbits)][0]) == row
        assert (out / f"lsqfib_n{nbits}_1.pt").exists()


def _jax_sweep_module():
    """``experiments/sweep.py`` (standard library imports only)."""
    spec = importlib.util.spec_from_file_location("jax_sweep", ROOT / "experiments/sweep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_runs_the_jax_sweeps_and_forwards_flags_in_order(tmp_path, monkeypatch):
    assert sweep.SWEEPS == _jax_sweep_module().SWEEPS
    runs = []
    monkeypatch.setattr(sweep.subprocess, "run", lambda cmd, **kw: runs.append(cmd))
    log = tmp_path / "s.txt"
    sweep.main(["attn", "--epochs", "2", "--ue-speed-kmh", "5", "--calibrated",
                "--log", str(log)])
    head = [sys.executable, "-m", "channelestimationtransformer_torch.cli.train_informer",
            "--epochs", "2", "--train-samples", "65536"]
    assert runs == [head + ["--attn", v, "--ue-speed-kmh", "5", "--calibrated"]
                    for v in ("full", "prob")]
    assert log.parent.exists()


def test_train_informer_attn_prob_runs(tmp_path, capsys):
    argv = CLI_SMALL + ["--attn", "prob", "--epochs", "1", "--steps-per-epoch", "1",
                        "--log-every", "1", "--out", str(tmp_path)]
    result = train_informer.main(argv)
    assert "_at_prob_" in result["name"] and result["name"] == jax_run_name(argv)
    assert np.isfinite(result["final_val_nmse"])
    assert (tmp_path / f"result_{result['name']}.json").exists()
