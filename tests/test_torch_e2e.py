"""The slice's drivers in the port against the JAX package's, on the CPU:
``cli/end_to_end_sim.py``, ``cli/collect_e2e.py``, ``cli/scale_demo.py`` and
``cli/int8_scale_ab.py``.

- The whole slice through ``end_to_end_sim.link_study``: a small Informer
  loaded with flax's weights (``utils/convert.py:load_flax``) and JAX's own
  batch; the prediction within 1e-5 of flax's; then, given JAX's draws for
  ``key(5)`` (the JAX driver's common random numbers), BER within 2 bits of
  the total and BLER equal at every Eb/N0, and SE within 1e-5 (relative) for
  each CSI source, uncoded and conv-coded, against the JAX driver's body run
  with the JAX package's functions.
- Each driver's flags against the JAX driver's source (the port adds
  ``--device`` to the drivers that compute; ``collect_e2e``'s ``--out`` is
  under ``weights/``).
- ``end_to_end_sim.main`` on the CPU writes the JAX driver's keys and lines,
  and ``collect_e2e`` parses them; ``collect_e2e.parse_log`` reads the
  committed ``logs/e2e_conv.log`` and ``logs/e2e_ls.log`` as JAX's.
- ``scale_demo``'s six sizes count the parameters of
  ``experiments/artifacts/scale_demo.json``; one tiny size and one tiny
  ``int8_scale_ab`` size run and write JAX's keys.
- On the JAX package's draws (channel, batch and link), the port's dataset,
  batch and ``end_to_end_sim.link_rows`` give the JAX driver's perfect and
  outdated rows: SE within 1e-4 (relative), BER within 2 bits.
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.channel import cdl as jcdl
from channelestimationtransformer_tpu.channel import dataset as jds
from channelestimationtransformer_tpu.data import windows as jwin
from channelestimationtransformer_tpu.sim import link as jlink
from channelestimationtransformer_tpu.sim import precoding as jprec

from channelestimationtransformer_torch.cli import (
    collect_e2e,
    end_to_end_sim,
    int8_scale_ab,
    scale_demo,
)
from channelestimationtransformer_torch.channel.cdl import CDLModel
from channelestimationtransformer_torch.channel.dataset import generate_beamformed_dataset
from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch, pack_features

from test_torch_channel import jax_cdl_draws, jax_chunk_keys
from test_torch_cli import _jax_flags, _port_flags
from test_torch_informer import SMALL, _flax_apply, _model_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
EBNO = [-4, -2, 0, 2, 4, 6, 8, 10]
B = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slice_inputs():
    """A small flax / port Informer pair and JAX's batch of 16 from a
    numpy-seeded dataset of 2 x 4 channels (16 packed features)."""
    rng = np.random.default_rng(0)
    fmod, tmod, params, stats, _, _ = _model_pair(rng, 2, **SMALL)
    h = rng.normal(size=(64, 40, 16)).astype(np.float32)
    ds = jwin.WindowDataset(h=jnp.asarray(h), seq_len=SMALL["seq_len"],
                            pred_len=SMALL["pred_len"], snr_db=21.0)
    batch = [np.asarray(x) for x in jwin.make_batch(jax.random.key(78), ds, B,
                                                    SMALL["label_len"])]
    return fmod, tmod, params, stats, batch


def _jax_driver_body(fmod, params, stats, batch, coded, fec, horizon=4):
    """``experiments/end_to_end_sim.py:95-139`` with the JAX package's functions."""
    enc_in, _, target = batch
    pred = _flax_apply(fmod, params, stats, *batch[:2])
    feat = lambda x: jnp.asarray(x).reshape(*x.shape[:-1], 2, 4, 2)  # noqa: E731
    h_true, h_pred, h_out = feat(target[:, horizon]), feat(pred[:, horizon]), feat(enc_in[:, -1])
    nmse = float(jnp.sum((h_true - h_pred) ** 2) / jnp.sum(h_true ** 2))
    res = {"pred": pred, "prediction_nmse": nmse, "ber": {}, "bler": {}, "se": {}}
    for name, h_pre in [("perfect", h_true), ("outdated", h_out), ("predicted", h_pred)]:
        bers, blers = [], []
        for ebno in EBNO:
            if coded:
                ber, bler, _ = jlink.simulate_coded_ber(
                    jax.random.key(5), h_true, h_pre, float(ebno), jlink.LinkConfig(), 128,
                    fec=fec)
                blers.append(float(bler))
            else:
                ber, _ = jlink.simulate_ber(jax.random.key(5), h_true, h_pre, float(ebno),
                                            jlink.LinkConfig(), 128)
            bers.append(float(ber))
        res["ber"][name], res["bler"][name] = bers, blers
        res["se"][name] = float(jnp.mean(jprec.precoded_spectral_efficiency(h_true, h_pre, 100.0)))
    return res


def _jax_draws(coded, b=B):
    """``sim/link.py``'s draws from ``key(5)`` at the driver's sizes (128
    symbols a stream, 2 streams, QPSK, perfect CSI, frequency domain)."""
    k_bits, k_noise = jax.random.split(jax.random.key(5))
    shape = (b, 128 * 2 * 2 // 2 - 6) if coded else (b, 128 * 2 * 2)
    payload = jax.random.bernoulli(k_bits, 0.5, shape)
    payload = np.asarray(payload.astype(jnp.int32 if coded else jnp.float32))
    kr, ki = jax.random.split(k_noise)
    noise = np.asarray(jax.random.normal(kr, (b, 2, 1, 128))
                       + 1j * jax.random.normal(ki, (b, 2, 1, 128))).astype(np.complex64)
    return {"info" if coded else "bits": torch.as_tensor(payload.copy()),
            "noise": torch.as_tensor(noise)}


@pytest.mark.parametrize("coded", [False, True], ids=["uncoded", "conv"])
def test_link_study_matches_the_jax_driver(slice_inputs, coded, capsys):
    fmod, tmod, params, stats, batch = slice_inputs
    want = _jax_driver_body(fmod, params, stats, batch, coded, "conv")
    enc_in, dec_in, target = (torch.as_tensor(x.copy()) for x in batch)
    got, bits = end_to_end_sim.link_study(tmod, enc_in, dec_in, target, ebno_db=EBNO,
                                          coded=coded, fec="conv", draws=_jax_draws(coded))
    pred = tmod(enc_in, dec_in).detach().numpy()
    assert np.max(np.abs(pred - want["pred"])) <= 1e-5
    assert got["prediction_nmse"] == pytest.approx(want["prediction_nmse"], rel=1e-5)
    total = B * (250 if coded else 512)
    assert bits == 3 * len(EBNO) * total
    for name in end_to_end_sim.SOURCES:
        assert got["se"][name] == pytest.approx(want["se"][name], rel=1e-5)
        diff = np.abs(np.array(got["ber"][name]) - np.array(want["ber"][name])) * total
        assert diff.max() <= 2, (name, got["ber"][name], want["ber"][name])
        if coded:
            assert got["bler"][name] == want["bler"][name]
    assert 0 < max(want["ber"]["perfect"]) < 0.5 and min(want["ber"]["outdated"]) > 0
    lines = [line for line in capsys.readouterr().out.splitlines() if ": SE " in line]
    assert [collect_e2e._LINE.match(line).group(1) for line in lines] == list(
        end_to_end_sim.SOURCES)


@pytest.mark.parametrize("driver, cli", [
    ("experiments/end_to_end_sim.py", end_to_end_sim),
    ("experiments/collect_e2e.py", collect_e2e),
    ("experiments/scale_demo.py", scale_demo),
    ("experiments/int8_scale_ab.py", int8_scale_ab),
])
def test_driver_flags_match_the_jax_drivers(driver, cli, monkeypatch):
    """Every flag of the JAX driver (``end_to_end_sim``'s channel flags
    included); the drivers that compute add ``--device`` alone, and
    ``collect_e2e`` adds none. ``collect_e2e``'s ``--out`` is
    ``weights/e2e_branches.json``, never the JAX artifact."""
    import ast

    if driver.endswith("collect_e2e.py"):  # its --out default is a path expression
        real = ast.literal_eval
        monkeypatch.setattr(ast, "literal_eval",
                            lambda n: real(n) if not isinstance(n, ast.Call) else "<path>")
    want = _jax_flags(driver)
    if driver.endswith("end_to_end_sim.py"):
        want.update({k: v for k, v in
                     _jax_flags("channelestimationtransformer_tpu/channel/cdl.py").items()
                     if k in ("--slot-symbols", "--ue-speed-kmh", "--calibrated")})
    got = _port_flags(cli.build_parser())
    added = set() if cli is collect_e2e else {"--device"}
    assert set(got) == set(want) | added
    for flag in want:
        if want[flag]["default"] == "<path>":
            assert got[flag]["default"] == "weights/e2e_branches.json"
            want[flag]["default"] = got[flag]["default"]
        assert got[flag] == want[flag], flag


DRIVER_CFG = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=32)


def test_end_to_end_sim_main_writes_the_jax_keys(monkeypatch, tmp_path, capsys):
    """The driver from a small model's checkpoint on a 64-sample dataset of
    key 77 (the batch from stream 78), conv-coded at two Eb/N0: JAX's keys,
    lines that ``collect_e2e.parse_log`` reads back, the closing JSON line;
    then ``collect_e2e`` merges the result under ``--extra``."""
    from channelestimationtransformer_torch.cli import _study
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
    from channelestimationtransformer_torch.train.trainer import create_train_state

    specs = []

    def datasets(args, cfg, device, *spec):
        specs.extend(spec)
        return _study.datasets(args, cfg, device, *((key, 64) for key, _ in spec))

    monkeypatch.setattr(end_to_end_sim, "InformerConfig",
                        functools.partial(InformerConfig, **DRIVER_CFG))
    monkeypatch.setattr(end_to_end_sim, "datasets", datasets)
    model = build_informer(InformerConfig(**DRIVER_CFG), device="cpu", seed=1)
    ckpt = save_checkpoint(create_train_state(model, TrainConfig()), str(tmp_path), "fp32_", 3)
    out = tmp_path / "e2e" / "e2e_coded_conv.json"
    res = end_to_end_sim.main(["--device", "cpu", "--checkpoint", ckpt, "--batch", "8",
                               "--ebno-db", "0", "10", "--coded", "--calibrated",
                               "--ue-speed-kmh", "5", "--out", str(out)])
    assert specs == [(77, 1024)]
    assert set(res) == {"prediction_nmse", "ebno_db", "ber", "se", "coded", "fec", "csi",
                        "domain", "bler"}
    assert (res["coded"], res["fec"], res["csi"], res["domain"]) == (True, "conv", "perfect",
                                                                     "freq")
    assert json.loads(out.read_text()) == res and res["ebno_db"] == [0.0, 10.0]
    log_lines = capsys.readouterr().out.splitlines()
    assert json.loads(log_lines[-1]) == {"sweep": "e2e", "nmse": res["prediction_nmse"]}
    assert log_lines[0].startswith("Prediction NMSE at horizon 4: ")
    log = tmp_path / "e2e.log"
    log.write_text("\n".join(log_lines))
    rec = collect_e2e.parse_log(str(log))
    assert rec["coded"] and set(rec["ber"]) == set(end_to_end_sim.SOURCES)
    for name in end_to_end_sim.SOURCES:
        assert rec["ber"][name] == res["ber"][name] and rec["bler"][name] == res["bler"][name]
        assert rec["se"][name] == round(res["se"][name], 2)
    merged = collect_e2e.main(["--extra", f"coded_conv={out}",
                               "--out", str(tmp_path / "e2e_branches.json")])
    assert merged["coded_conv"] == res
    assert json.loads((tmp_path / "e2e_branches.json").read_text()) == merged


def test_collect_e2e_parses_the_committed_logs_as_jax():
    """The port's ``parse_log`` against JAX's on the committed conv and LS
    logs (tqdm frames included), and the merge of the committed artifacts."""
    sys.path.insert(0, str(ROOT))
    from experiments.collect_e2e import parse_log as jax_parse_log

    for log in ("logs/e2e_conv.log", "logs/e2e_ls.log"):
        got = collect_e2e.parse_log(str(ROOT / log))
        assert got == jax_parse_log(str(ROOT / log)) and got["recovered_from"] == log
    assert collect_e2e.parse_log(str(ROOT / "logs/e2e_ls.log"))["se"] == {
        "perfect": 11.5, "outdated": 11.42, "predicted": 11.46}


def _param_count(cfg):
    """Parameters of ``cfg``'s InformerStack, built on the meta device."""
    from channelestimationtransformer_torch.models.informer import InformerStack

    with torch.device("meta"):
        return sum(p.numel() for p in InformerStack(cfg).parameters())


def test_scale_demo_sizes_count_the_jax_parameters():
    rows = json.loads((ROOT / "experiments/artifacts/scale_demo.json").read_text())
    assert [r["config"] for r in rows] == [s[0] for s in scale_demo.SIZES]
    for (name, d_model, d_ff, seq_len, batch), row in zip(scale_demo.SIZES, rows):
        assert (d_model, d_ff, seq_len, batch) == (row["d_model"], row["d_ff"], row["seq_len"],
                                                   row["batch"])
        cfg = scale_demo.size_config(d_model, d_ff, seq_len, "bfloat16")
        assert _param_count(cfg) == row["params"], name


def test_scale_demo_runs_a_tiny_size_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(scale_demo, "SIZES", [("tiny", 16, 32, 24, 8)])
    monkeypatch.setattr(scale_demo, "size_config", functools.partial(
        scale_demo.size_config, n_heads=2, e_layers=(2, 1), d_layers=1))
    out = tmp_path / "scale_demo.json"
    rows = scale_demo.main(["--device", "cpu", "--dtype", "float32", "--steps", "2",
                            "--chunks", "1", "--out", str(out)])
    (row,) = rows
    assert set(row) == {"config", "d_model", "d_ff", "seq_len", "batch", "params", "dtype",
                        "ms_per_step", "samples_per_s", "gflops_per_step", "achieved_tflops",
                        "mxu_fraction", "peak_tflops", "device"}
    assert row["params"] == _param_count(scale_demo.size_config(16, 32, 24,
                                                                          "float32"))
    assert row["gflops_per_step"] > 0 and row["peak_tflops"] == 67.0
    assert json.loads(out.read_text()) == rows
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row


def test_scale_demo_flops_count_a_dense_layer_exactly():
    """The counter's count of one plain step against the dense layers' own
    2 x m x k x n, forward and backward (the FLOPs that dominate at scale)."""
    from torch.utils.flop_counter import FlopCounterMode

    layer = torch.nn.Linear(64, 32, bias=False)
    x = torch.randn(8, 64, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        layer(x).sum().backward()
    assert counter.get_total_flops() == 3 * 2 * 8 * 64 * 32


def test_int8_scale_ab_runs_a_tiny_size_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(int8_scale_ab, "SIZES", [("tiny", 32, 32, 24, 4)])
    monkeypatch.setattr(int8_scale_ab, "InformerConfig", functools.partial(
        InformerConfig, n_heads=2, e_layers=(2, 1), d_layers=1))
    out = tmp_path / "int8_scale_ab.json"
    (row,) = int8_scale_ab.main(["--device", "cpu", "--scan", "2", "--reps", "1",
                                 "--out", str(out)])
    variants = ("float32", "bfloat16", "int8", "int8_wo")
    keys = {"config", "d_model", "d_ff", "seq_len", "batch", "device",
            *(f"ms_{v}" for v in variants), *(f"samples_per_s_{v}" for v in variants),
            *(f"{v}_speedup_vs_{b}" for v in ("int8", "int8_wo") for b in ("f32", "bf16"))}
    assert set(row) == keys
    assert all(row[f"ms_{v}"] > 0 for v in variants)
    assert row["int8_speedup_vs_f32"] == round(row["ms_float32"] / row["ms_int8"], 3)
    assert json.loads(out.read_text()) == [row]


@pytest.mark.parametrize("dtype, mode", [("bfloat16", "weight_only"), ("float32", "w8a8")])
def test_int8_scale_ab_variants_match_jax(dtype, mode):
    """The A/B's served variants on their bases against JAX's intercept under
    ``jax.jit``: weight-only on a bf16 model (a served projection keeps its
    input's dtype, so attention meets f32 and bf16 operands in f32, as
    ``jnp.einsum`` promotes) and W8A8 on the f32 one, on the small stack:
    NMSE <= 1e-3 in bf16 (seen 1.1e-4) and 1e-8 in f32 (seen 5e-14)."""
    from channelestimationtransformer_tpu.ops.quant import serving as js

    from channelestimationtransformer_torch.ops.quant import serving as ts

    rng = np.random.default_rng(3)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 4, dtype=dtype, **SMALL)
    variables = {"params": params, "batch_stats": stats}
    jtable = js.build_int8_table(variables)

    def served(v, a, b):
        with js.serving_intercept(jtable, mode=mode):
            return fmod.apply(v, a, b)
    want = np.asarray(jax.jit(served)(variables, jnp.asarray(x_enc),
                                      jnp.asarray(x_dec))).astype(np.float32)
    got = ts.predict_int8(tmod, torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                          mode=mode).float().numpy()
    nmse = np.square(got - want).sum() / np.square(want).sum()
    assert nmse <= (1e-3 if dtype == "bfloat16" else 1e-8), nmse


def test_channel_spread_on_jax_draws_gives_the_jax_driver_rows():
    """The targets' perfect and outdated rows need no predictor. On JAX's
    own draws (key 77's channel chunks of 128, the batch of ``key(78)``, the
    link draws of ``key(5)``), the port's dataset, batch and
    ``end_to_end_sim.link_rows`` give the JAX driver's rows: SE within 1e-4
    (relative) and BER within 2 bits. 16 samples, a batch of 8."""
    n, b, n_slots = 16, 8, 100
    ref = jcdl.CDLModel.calibrated(ue_speed_kmh=5.0)
    draws = [jax_cdl_draws(k, ref, size) for k, size in jax_chunk_keys(jax.random.key(77), n, 128)]
    h = generate_beamformed_dataset(77, model=CDLModel.calibrated(ue_speed_kmh=5.0),
                                    num_samples=n, num_slots=n_slots, batch_size=128,
                                    device="cpu", draws=draws)
    cfg = InformerConfig()
    ds = WindowDataset(h=pack_features(h), seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                       snr_db=21.0, device="cpu")
    k_idx, k_start, k_noise = jax.random.split(jax.random.key(78), 3)
    idx = jax.random.randint(k_idx, (b,), 0, n)
    starts = jax.random.randint(k_start, (b,), 0, n_slots - cfg.seq_len - cfg.pred_len + 1)
    noise = jax.random.normal(k_noise, (b, n_slots, 16))
    enc_in, _, target = make_batch(ds, b, cfg.label_len,
                                   **{name: torch.as_tensor(np.array(x)) for name, x in
                                      (("idx", idx), ("starts", starts), ("noise", noise))})
    h_true = end_to_end_sim.features_to_channel(target[:, 4], 2, 4)
    h_out = end_to_end_sim.features_to_channel(enc_in[:, -1], 2, 4)
    got, _ = end_to_end_sim.link_rows(h_true, (("perfect", h_true), ("outdated", h_out)),
                                      ebno_db=[0.0, 10.0], draws=_jax_draws(False, b))

    jds_ = jds.make_window_dataset(jax.random.key(77), model=ref, num_samples=n,
                                   num_slots=n_slots, seq_len=cfg.seq_len,
                                   pred_len=cfg.pred_len, snr_db=21.0)
    enc_j, _, target_j = jwin.make_batch(jax.random.key(78), jds_, b, cfg.label_len)
    h_true_j = target_j[:, 4].reshape(b, 2, 4, 2)
    for name, h_pre in (("perfect", h_true_j), ("outdated", enc_j[:, -1].reshape(b, 2, 4, 2))):
        se = float(jnp.mean(jprec.precoded_spectral_efficiency(h_true_j, h_pre, 100.0)))
        assert got[name]["se"] == pytest.approx(se, rel=1e-4)
        for ebno, ber in zip((0.0, 10.0), got[name]["ber"]):
            want, total = jlink.simulate_ber(jax.random.key(5), h_true_j, h_pre, ebno,
                                             jlink.LinkConfig(), 128)
            assert abs(ber - float(want)) * int(total) <= 2, (name, ebno, ber, float(want))
