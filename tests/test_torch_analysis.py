"""The analysis drivers of the port (``cli/``: ar_oracle, eval_parity_ci,
collect_results, make_figures, timing_analysis, complexity_report) and
``utils/figures`` against the JAX package's ``experiments/`` drivers.

The JAX drivers switch JAX's runtime on at import, so their pure-numpy
functions (``ar_oracle_nmse``, ``bootstrap_ci``) are compiled here from
their source, and ``collect_results.py`` and ``make_figures.py`` run as
subprocesses on the same files as the port's.
"""

import ast
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_tpu.utils import figures as jax_figures

from channelestimationtransformer_torch.channel.cdl import CDLModel
from channelestimationtransformer_torch.channel.dataset import make_window_dataset
from channelestimationtransformer_torch.cli import (
    ar_oracle,
    collect_results,
    complexity_report,
    eval_parity_ci,
    make_figures,
    timing_analysis,
)
from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.core.runtime import stream_generator
from channelestimationtransformer_torch.data.windows import sample_windows
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
from channelestimationtransformer_torch.train.trainer import create_train_state
from channelestimationtransformer_torch.utils import figures

ROOT = pathlib.Path(__file__).resolve().parents[1]
ART = ROOT / "experiments" / "artifacts"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_function(driver, name):
    """A top-level function of an ``experiments/`` driver, compiled from its
    source with numpy as its only global."""
    tree = ast.parse((ROOT / "experiments" / driver).read_text())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np}
    exec(compile(ast.Module([node], []), driver, "exec"), ns)
    return ns[name]


def _run_jax(driver, *args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / "experiments" / driver), *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


# --- ar_oracle ---------------------------------------------------------------------

AR_RTOL = 1e-4  # the batched solves sum in another order than numpy's row-by-row ones


def test_ar_oracle_nmse_equals_jax_on_the_same_windows():
    """On the port's own windows (CDL-B at 14-symbol slots, SNR 12) and on a
    noisy sum of sinusoids, order 30 and 10: the scalar and per-horizon
    NMSEs within ``AR_RTOL`` of the JAX driver's numpy loop."""
    jax_oracle = jax_function("ar_oracle.py", "ar_oracle_nmse")
    model = CDLModel(sampling_frequency=120e3 / 14, ue_speed_ms=30 / 3.6)
    ds = make_window_dataset(1234, model=model, num_samples=16, num_slots=100, snr_db=12.0,
                             device="cpu")
    _, _, hist, future = sample_windows(ds, 24, generator=stream_generator("cpu", 5678))
    rng = np.random.default_rng(0)
    t = np.arange(95)[None, :, None]
    waves = (np.sin(0.1 * t * np.arange(1, 17)) + 0.1 * rng.standard_normal((8, 95, 16)))
    waves = waves.astype(np.float32)
    for h, f, order in ((hist.numpy(), future.numpy(), 30), (waves[:, :90], waves[:, 90:], 10)):
        want = jax_oracle(h, f, order)
        got = ar_oracle.ar_oracle_nmse(torch.from_numpy(h), torch.from_numpy(f), order)
        assert got[0] == pytest.approx(want[0], rel=AR_RTOL)
        assert got[1] == pytest.approx(want[1], rel=AR_RTOL)
        assert len(got[1]) == 5


# --- eval_parity_ci -------------------------------------------------------------

def test_bootstrap_ci_equals_jax():
    jax_ci = jax_function("eval_parity_ci.py", "bootstrap_ci")
    vals = np.random.default_rng(3).gamma(2.0, 0.004, size=64)
    assert eval_parity_ci.bootstrap_ci(vals) == jax_ci(vals)
    assert eval_parity_ci.bootstrap_ci(vals[:8], n_boot=500, seed=4) == jax_ci(vals[:8], 500, 4)


def test_eval_parity_ci_driver_on_a_checkpoint(tmp_path, capsys):
    """A run named as ``cli.train_informer`` names it, its checkpoint on
    disk: the row's keys, 4 batch values, the CI around their mean, the dB
    delta against its reference; a row with no checkpoint says so."""
    name = ("ei_16_di_16_co_16_sl_90_ll_10_pl_5_f_5_dm_16_nh_8_el_[4, 3]_dl_3_df_16_do_0.05"
            "_at_full_em_fixed_ac_gelu_20_cal_v5_tiny")
    fields = collect_results.parse_name(name)
    model = build_informer(eval_parity_ci.cfg_from_fields(fields), device="cpu", seed=0)
    save_checkpoint(create_train_state(model, TrainConfig()), str(tmp_path), f"tmodel_{name}_", 3)
    parity = {"sweeps": {"snr": {"rows": {"20": {"run": name, "ref": 0.0074},
                                          "18": {"run": name.replace("_20_", "_18_"),
                                                 "ref": 0.0128}}}}}
    (tmp_path / "parity.json").write_text(json.dumps(parity))
    out = eval_parity_ci.main(["--parity", str(tmp_path / "parity.json"), "--weights",
                               str(tmp_path), "--batches", "4", "--val-samples", "32",
                               "--device", "cpu", "--out", str(tmp_path / "ci.json")])
    row = out["rows"]["snr:20"]
    assert set(row) == {"checkpoint_epoch", "n", "mean", "ci95", "per_batch_std", "ref",
                        "delta_db", "delta_db_ci95", "excludes_zero"}
    assert row["checkpoint_epoch"] == 3 and row["n"] == 4
    assert row["ci95"][0] <= row["mean"] <= row["ci95"][1] and np.isfinite(row["mean"])
    assert row["delta_db"] == pytest.approx(10 * np.log10(row["mean"] / 0.0074))
    assert out["rows"]["snr:18"] == {"error": "no checkpoint on disk"}
    assert json.loads((tmp_path / "ci.json").read_text()) == out
    assert "wrote" in capsys.readouterr().out.splitlines()[-1]


# --- collect_results ---------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    [],
    ["--base", str(ART / "parity.json"), "--ci", str(ART / "parity_ci.json"), "--tag", "r2cos"],
])
def test_collect_results_equals_jax_on_the_committed_results(extra, tmp_path, capsys):
    """A copy of ``experiments/artifacts/result_*.json`` through both
    drivers: ``snr_table.json``, ``parity.json`` and ``PARITY_RESULTS.md``
    equal byte for byte, and the printed markdown equal."""
    results = sorted(ART.glob("result_*.json"))
    assert len(results) > 30
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        for path in results:
            shutil.copy(path, tmp_path / side)
    ci = [] if extra else ["--ci", str(tmp_path / "none.json")]  # JAX's default is its artifact
    jax_out = _run_jax("collect_results.py", str(tmp_path / "jax"), "--art", str(ART),
                       *extra, *ci)
    parity = collect_results.main([str(tmp_path / "port"), "--art", str(ART), *extra, *ci])
    assert capsys.readouterr().out == jax_out
    for name in ("snr_table.json", "parity.json", "PARITY_RESULTS.md"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert parity == json.loads((tmp_path / "port" / "parity.json").read_text())
    assert len(parity["sweeps"]["seq_len"]["rows"]) == 4


# --- make_figures and figures -----------------------------------------------------

def test_make_figures_makes_the_jax_drivers_files(tmp_path, capsys):
    """Over the committed artifacts and one training log: the same figure
    files, in the same order."""
    args = ["--weights-dir", str(ART), "--logs", str(ROOT / "logs" / "r5base.log")]
    jax_made = json.loads(_run_jax("make_figures.py", *args, "--out",
                                   str(tmp_path / "jax")).splitlines()[-1])["figures"]
    cwd = os.getcwd()
    os.chdir(ROOT)  # the crossover artifact is read relative to the working directory, as in JAX
    try:
        made = make_figures.main([*args, "--out", str(tmp_path / "port")])
    finally:
        os.chdir(cwd)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"figures": made}
    assert [pathlib.Path(p).name for p in made] == [pathlib.Path(p).name for p in jax_made]
    assert len(made) >= 15 and all(pathlib.Path(p).stat().st_size > 0 for p in made)


def test_figures_functions_write_what_jax_writes(tmp_path):
    rng = np.random.default_rng(0)
    sweep = {"informer": {12.0: [0.02] * 5, 20.0: [0.01] * 5}}
    hist, pred = rng.standard_normal((90, 16)), rng.standard_normal((5, 16))
    h = rng.standard_normal((50, 4)) + 1j * rng.standard_normal((50, 4))
    parsed = {"run": {"epochs": [0, 1], "valid_loss": [0.1, 0.05]}}
    calls = [("plot_nmse_vs_snr", (sweep,)), ("plot_nmse_vs_horizon", ({"m": [0.01, 0.02]},)),
             ("plot_prediction_debug", (hist, pred, pred)),
             ("plot_channel_trajectories", (h,)), ("plot_loss_curves", (parsed,))]
    for side, module in (("jax", jax_figures), ("port", figures)):
        (tmp_path / side).mkdir()
        for name, args in calls:
            path = str(tmp_path / side / f"{name}.png")
            assert getattr(module, name)(*args, path) == path
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))


# --- timing_analysis and complexity_report ---------------------------------------

def test_timing_analysis_driver_small(tmp_path, capsys):
    """Two axes at batch 4 (the batch axis at its own 64-256), one rep of
    one forward a point: the JAX driver's keys, JSON and pickle equal, a
    monotonicity verdict. No time is asserted."""
    out = tmp_path / "runtime.json"
    results = timing_analysis.main(["--device", "cpu", "--params", "seq_len", "batch",
                                    "--batch", "4", "--reps", "1", "--inner", "1",
                                    "--out", str(out)])
    keys = [f"seq_len={v}" for v in (25, 50, 75, 90)] + [f"batch={v}" for v in (64, 128, 256)]
    assert list(results) == keys + ["_monotonic"]
    assert isinstance(results["_monotonic"], bool)
    assert all(set(results[k]) == {"mean_ms", "std_ms", "samples_per_s"} for k in keys)
    assert json.loads(out.read_text()) == results
    with open(tmp_path / "runtime.pickle", "rb") as f:
        assert pickle.load(f) == results
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"sweep": "timing", "entries": 8, "monotonic": results["_monotonic"]}
    # The sweep's configs are the JAX driver's: BASE with one field replaced.
    cfgs = dict((k, c) for k, c, _ in timing_analysis.sweep_configs(["n_heads"], 256))
    assert cfgs["n_heads=16"] == InformerConfig(**{**timing_analysis.BASE, "n_heads": 16})


def test_complexity_report_driver(tmp_path, capsys):
    out = tmp_path / "complexity.json"
    report = complexity_report.main(["--device", "cpu", "--batch", "2", "--out", str(out)])
    committed = json.loads((ART / "complexity.json").read_text())
    assert list(report) == list(committed)
    for name, row in report.items():
        assert set(row) == set(committed[name])
        assert row["params"] == committed[name]["params"]
        assert row["macs_total"] == 2 * row["macs_per_sample"]
    assert report["informer_stack"]["macs_per_sample"] == 43_688_704
    assert json.loads(out.read_text()) == report
    assert "informer_stack: params=1,293,072 MACs/sample=43,688,704" in capsys.readouterr().out
