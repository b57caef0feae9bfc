"""The last eight experiment drivers of the port (``cli/``: calibrate_channel,
calibrate_fast, prob_crossover, prob_profile, step_profile, perf_study,
interleaved_ab, pallas_ab) and ``cli/channel_spread.py`` against the JAX
package's ``experiments/`` drivers.

The JAX drivers switch JAX's runtime on at import, so their functions are
compiled here from their source (numpy ones with numpy as their only
global, ``prob_pieces`` with jax), and the drivers whose results are held
whole run as subprocesses on the CPU. No test here asserts a time.
Tolerances, each named where it is used:

- the calibration helpers on the same complex64 arrays: ``lag_curve`` and
  ``fit_gap_cost`` rtol 1e-5, ``hankel_rank`` equal, the Wiener bounds rtol
  1e-3 (complex64 solves of 720-1440-dimensional systems, LAPACK through
  numpy against LAPACK through torch);
- the fits on JAX's draws (the port's channel within 1e-4 of JAX's, as
  ``tests/test_torch_channel.py`` holds it): the Wiener values rtol 2e-3,
  the rounded dB values within 0.02 dB, the fitted speed equal;
- ``prob_pieces`` stage by stage: rtol 1e-5 / atol 1e-5;
- ``pallas_ab``: byte for byte.
"""

import ast
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.channel import cdl as jcdl

from channelestimationtransformer_torch.cli import (
    calibrate_channel,
    calibrate_fast,
    interleaved_ab,
    pallas_ab,
    perf_study,
    prob_crossover,
    prob_profile,
    step_profile,
)

from test_torch_channel import jax_cdl_draws, jax_chunk_keys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ART = ROOT / "experiments" / "artifacts"
SMALL_MODEL = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_function(driver, name, **globals_):
    """A top-level function of an ``experiments/`` driver, compiled from its
    source with numpy (and ``globals_``) as its globals."""
    tree = ast.parse((ROOT / "experiments" / driver).read_text())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np, **globals_}
    exec(compile(ast.Module([node], []), driver, "exec"), ns)
    return ns[name]


def _run_jax(driver, *args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / "experiments" / driver), *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _jax_flags(driver):
    """``--flag -> (default or None if not a literal, type name)`` of every
    ``add_argument`` call in a JAX driver's source."""
    flags = {}
    for node in ast.walk(ast.parse((ROOT / "experiments" / driver).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            try:
                default = ast.literal_eval(kw["default"]) if "default" in kw else None
            except ValueError:
                default = "<expression>"
            flags[node.args[0].value] = (default, kw["type"].id if "type" in kw else None,
                                         ast.literal_eval(kw["nargs"]) if "nargs" in kw
                                         else None)
    return flags


@pytest.mark.parametrize("driver,cli,added", [
    ("calibrate_channel.py", calibrate_channel, {"--pickle"}),
    ("calibrate_fast.py", calibrate_fast, set()),
    ("prob_crossover.py", prob_crossover, {"--shapes", "--out"}),
    ("prob_profile.py", prob_profile, set()),
    ("step_profile.py", step_profile, {"--steps"}),
    ("perf_study.py", perf_study, {"--steps"}),
    ("interleaved_ab.py", interleaved_ab, set()),
])
def test_flags_match_the_jax_driver(driver, cli, added):
    """Every flag of the JAX driver with its type, nargs and default (an
    ``--out`` under ``weights/``, where JAX's may point into its
    artifacts); the port adds ``--device`` and the flags named here:
    ``--pickle`` (JAX reads the reference's pickle at a fixed path),
    ``--shapes`` / ``--out`` (JAX's crossover takes no flags) and
    ``--steps`` (JAX's steps a chunk, a constant 10 there)."""
    want = _jax_flags(driver)
    got = {a.option_strings[0]: (a.default, a.type.__name__ if a.type else None, a.nargs)
           for a in cli.build_parser()._actions if a.option_strings[0] != "-h"}
    assert set(got) == set(want) | added | {"--device"}
    for flag, (default, typ, nargs) in want.items():
        assert got[flag][1:] == (typ, nargs), flag
        if flag != "--out" and default != "<expression>":
            assert got[flag][0] == default, flag
    assert got["--out"][0].startswith("weights/")


# --- calibrate_channel / calibrate_fast ---------------------------------------------


def _complex_channel(seed, n=24, t=95, f=8):
    """A smooth complex64 ``[n, t, f]`` ensemble (sums of slow rotations)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.02, 0.2, size=(n, 1, f, 4))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, f, 4))
    amp = rng.normal(size=(n, 1, f, 4)) + 1j * rng.normal(size=(n, 1, f, 4))
    x = (amp * np.exp(1j * (w * np.arange(t)[None, :, None, None] + phase))).sum(-1)
    x = x + 0.05 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return x.astype(np.complex64)


def test_calibration_helpers_equal_jax_on_the_same_arrays():
    """``lag_curve``, ``hankel_rank`` and ``wiener_curve`` of
    ``calibrate_channel``, ``wiener_bound`` and ``fit_gap_cost`` of
    ``calibrate_fast``, on the same complex64 arrays as the JAX drivers'."""
    x = _complex_channel(0)
    xt = torch.from_numpy(x)
    want = jax_function("calibrate_channel.py", "lag_curve")(x)
    got = calibrate_channel.lag_curve(xt)
    assert list(got) == list(want) == [1, 2, 3, 5, 10]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-5)
    for window in (15, 8):
        assert calibrate_channel.hankel_rank(xt[:, :30], window) == jax_function(
            "calibrate_channel.py", "hankel_rank")(x[:, :30], window)
    ns = {"REF_SNR_TABLE": calibrate_channel.REF_SNR_TABLE}
    got = calibrate_channel.wiener_curve(xt[:, :45], seq=40)
    want = jax_function("calibrate_channel.py", "wiener_curve", **ns)(x[:, :45], seq=40)
    assert list(got) == list(want) == [12, 14, 16, 18, 20]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-3)
    jax_bound = jax_function("calibrate_fast.py", "wiener_bound", SNR_DB=21.0)
    for seq, snr in ((25, 21.0), (60, 12.0)):
        total, per_h = calibrate_fast.wiener_bound(xt, seq, snr)
        want_total, want_h = jax_bound(x, seq, snr)
        np.testing.assert_allclose(total, want_total, rtol=1e-3)
        np.testing.assert_allclose(per_h, want_h, rtol=1e-3)
    jax_cost = jax_function("calibrate_fast.py", "fit_gap_cost")
    refs = calibrate_fast.REF_SEQ_LEN
    for bounds in ({25: 0.2, 50: 0.1, 75: 0.05, 90: 0.04}, {25: 0.5, 50: 0.1, 75: 0.05, 90: 0.04},
                   {25: 0.349, 50: 0.177, 75: 0.102, 90: 0.080}):
        got, want = calibrate_fast.fit_gap_cost(bounds, refs), jax_cost(bounds, refs)
        assert (got[0] is None) == (want[0] is None)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        if got[0] is not None:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


def _with_jax_draws(monkeypatch, module, model_of):
    """``module.generate`` fed the draws JAX's driver makes from
    ``PRNGKey(seed)`` for the channel ``model_of(*args)`` gives."""
    real = module.generate

    def generate(*args, **kwargs):
        n, t, seed = args[1], args[2], kwargs.get("seed", args[3] if len(args) > 3 else 0)
        jmodel = model_of(args[0])
        chunks = jax_chunk_keys(jax.random.PRNGKey(seed), n, min(n, 512))
        draws = [jax_cdl_draws(k, jmodel, b) for k, b in chunks]
        return real(*args, **kwargs, draws=draws)

    monkeypatch.setattr(module, "generate", generate)


def _fit_rows_close(got, want, keys):
    for key in keys:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert set(g) == set(w), key
            _fit_rows_close(g, w, w)
        elif isinstance(w, list):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=0.02, err_msg=key)
        elif isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=0.02, err_msg=key)
        else:
            assert g == w, key


def test_calibrate_channel_fit_on_jax_draws_equals_the_jax_driver(monkeypatch, tmp_path):
    """``--speeds 5,30 --n 32`` on the draws of the JAX driver's key: every
    Wiener value, dB delta and RMS of the JSON and the fitted speed as the
    JAX driver's run on the CPU."""
    argv = ["--speeds", "5,30", "--n", "32"]
    _run_jax("calibrate_channel.py", *argv, "--out", str(tmp_path / "jax.json"))
    want = json.loads((tmp_path / "jax.json").read_text())
    _with_jax_draws(monkeypatch, calibrate_channel, lambda v: jcdl.CDLModel(
        sampling_frequency=1.0 / calibrate_channel.SLOT_PERIOD, ue_speed_ms=v / 3.6))
    calibrate_channel.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want)
    _fit_rows_close(got, want, want)
    assert got["fitted_speed_kmh"] == want["fitted_speed_kmh"]


def test_calibrate_fast_fit_on_jax_draws_equals_the_jax_driver(monkeypatch, tmp_path):
    """``--speeds 10 --slot-symbols 25 --n 32`` (seeds 2 and 3, JAX's) on
    the JAX driver's draws: every bound, gap, RMS and fit as its run's."""
    argv = ["--speeds", "10", "--slot-symbols", "25", "--n", "32"]
    _run_jax("calibrate_fast.py", *argv, "--out", str(tmp_path / "jax.json"))
    want = json.loads((tmp_path / "jax.json").read_text())

    def model_of(m):
        return jcdl.CDLModel(sampling_frequency=m.sampling_frequency, ue_speed_ms=m.ue_speed_ms)

    _with_jax_draws(monkeypatch, calibrate_fast, model_of)
    calibrate_fast.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want)
    _fit_rows_close(got, want, want)


def test_calibrate_channel_keys_and_pickle_prong(tmp_path):
    """The port's own draws: the committed artifact's keys, the fitted
    speed from the grid; with ``--pickle`` the slot-geometry prong adds the
    four keys the committed artifact holds (on a stand-in pickle here)."""
    rng = np.random.default_rng(1)
    sample = (rng.normal(size=(4, 30, 2, 4)) + 1j * rng.normal(size=(4, 30, 2, 4)))
    (tmp_path / "channel.pickle").write_bytes(__import__("pickle").dumps(sample))
    out = calibrate_channel.main(["--device", "cpu", "--speeds", "6", "--n", "16",
                                  "--pickle", str(tmp_path / "channel.pickle"),
                                  "--out", str(tmp_path / "c.json")])
    committed = json.loads((ART / "calibration.json").read_text())
    assert set(json.loads((tmp_path / "c.json").read_text())) == set(committed)
    assert out["fitted_speed_kmh"] == 6.0
    assert 0 < out["pickle_hankel_rank"] <= 15


# --- pallas_ab ---------------------------------------------------------------------

R4AB = ("result_ei_16_di_16_co_16_sl_90_ll_10_pl_5_f_5_dm_128_nh_8_el_[4, 3]_dl_3_df_64_do_0.05"
        "_at_full_em_fixed_ac_gelu_21_cal_v5_bf16_rbg_pallas_r4ab.json")
R3PAL = R4AB.replace("_bf16_rbg_pallas_r4ab", "_pallas_r3pal")


@pytest.mark.parametrize("runs,pick", [((R4AB,), "r4ab"), ((R4AB, R3PAL), "r3pal")])
def test_pallas_ab_reproduces_the_jax_driver(tmp_path, runs, pick):
    """On a folder holding copies of the r4ab result (and the r3pal one)
    and ``parity.json``: the port writes what the JAX driver writes, byte
    for byte; with r4ab alone both reproduce the committed
    ``pallas_ab.json``, and with both the sorted glob picks r3pal."""
    outs = {}
    for side in ("port", "jax"):
        folder = tmp_path / side
        folder.mkdir()
        for name in (*runs, "parity.json"):
            shutil.copy(ART / name, folder / name)
        if side == "port":
            pallas_ab.main([str(folder)])
        else:
            _run_jax("pallas_ab.py", str(folder))
        outs[side] = (folder / "pallas_ab.json").read_bytes()
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"])["pallas_run"].endswith(pick)
    if pick == "r4ab":
        assert outs["port"] == (ART / "pallas_ab.json").read_bytes()


# --- prob_profile / prob_crossover --------------------------------------------------


@pytest.mark.parametrize("mask_flag", [False, True])
def test_prob_pieces_equal_jax_stage_by_stage(mask_flag):
    """Each of the five stages of the port's ``prob_pieces`` against JAX's
    (compiled from ``experiments/prob_profile.py``) on the same q, k, v and
    the ``index_sample`` JAX draws from its key."""
    jax_pieces = jax_function("prob_profile.py", "prob_pieces", jax=jax, jnp=jnp, math=math)
    rng = np.random.default_rng(3)
    l = 24
    q, k, v = (rng.normal(size=(2, l, 2, 8)).astype(np.float32) for _ in range(3))
    key = jax.random.key(7)
    sample_k = min(5 * math.ceil(math.log(l)), l)
    index_sample = torch.from_numpy(np.array(jax.random.randint(key, (l, sample_k), 0, l)))
    for upto in range(1, 6):
        want = np.asarray(jax_pieces(*map(jnp.asarray, (q, k, v)), mask_flag=mask_flag,
                                     factor=5, rng=key, upto=upto))
        got = prob_profile.prob_pieces(*map(torch.from_numpy, (q, k, v)), mask_flag=mask_flag,
                                       factor=5, index_sample=index_sample, upto=upto)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=upto)


def test_prob_profile_and_crossover_keys(monkeypatch, tmp_path):
    """Both drivers at a tiny size on the CPU: the committed artifacts'
    keys (every row of ``prob_profile.json``; ``prob_crossover.json``'s
    note, rows and their keys)."""
    monkeypatch.setattr(prob_profile, "ENC_SHAPE", (2, 20, 2, 8))
    monkeypatch.setattr(prob_profile, "DEC_SHAPE", (2, 10, 2, 8))
    monkeypatch.setattr(prob_profile, "REPS", 1)
    out = prob_profile.main(["--device", "cpu", "--out", str(tmp_path / "p.json")])
    assert list(out) == list(json.loads((ART / "prob_profile.json").read_text()))
    monkeypatch.setattr(prob_crossover, "H", 2)
    out = prob_crossover.main(["--device", "cpu", "--shapes", "16:2,40:1",
                               "--out", str(tmp_path / "c.json")])
    committed = json.loads((ART / "prob_crossover.json").read_text())
    assert set(out) == set(committed)
    assert [r["l"] for r in out["rows"]] == [16, 40]
    assert all(set(r) == set(committed["rows"][0]) for r in out["rows"])


# --- step_profile / perf_study / interleaved_ab -------------------------------------


@pytest.fixture
def tiny_training(monkeypatch):
    """The training drivers on a small model, batch 4, 64 samples."""
    for module in (perf_study, step_profile):
        monkeypatch.setattr(module, "MODEL_KWARGS", SMALL_MODEL)
        monkeypatch.setattr(module, "BATCH", 4)
        monkeypatch.setattr(module, "SAMPLES", 64)


def test_step_profile_keys(tiny_training, tmp_path):
    """The 13 rows (``error`` in none), ``vs_canonical``'s five and the
    batch note, as the committed ``step_profile.json``."""
    out = step_profile.main(["--device", "cpu", "--chunks", "1", "--steps", "1",
                             "--out", str(tmp_path / "s.json")])
    committed = json.loads((ART / "step_profile.json").read_text())
    assert set(out) == set(committed)
    assert list(out["rows"]) == list(committed["rows"])
    assert all(set(r) == {"ms_per_step", "samples_per_s"} for r in out["rows"].values())
    assert set(out["vs_canonical"]) == set(committed["vs_canonical"])


def test_perf_study_and_interleaved_ab_keys(tiny_training, monkeypatch, tmp_path):
    """perf_study's three sections and interleaved_ab's rows at a tiny size:
    the committed ``perf_study.json``'s and ``interleaved_ab_r5.json``'s
    keys row for row, plus the route each row timed (``route``) and, on the
    ``+rbg`` rows, the variant they ran as (``runs_as``)."""
    monkeypatch.setattr(perf_study, "ATTN_SHAPES", [(2, 16), (1, 160)])
    monkeypatch.setattr(perf_study, "GRAD_SHAPE", (2, 16))
    monkeypatch.setattr(perf_study, "QUANT_SIZES", (1000,))
    monkeypatch.setattr(perf_study, "INNER", 1)
    out = perf_study.main(["--device", "cpu", "--reps", "1", "--steps", "1",
                           "--out", str(tmp_path / "p.json")])
    committed = json.loads((ART / "perf_study.json").read_text())
    assert set(out) == set(committed)
    want = {(r["bench"], "ms_bd" in r): set(r) for rows in committed.values() for r in rows}
    for rows in out.values():
        for r in rows:
            assert set(r) - {"route", "runs_as"} == want[(r["bench"], "ms_bd" in r)], r
            assert ("runs_as" in r) == ("rbg" in r.get("dtype", ""))
    assert [r["max_abs_err"] for r in out["quant_ab"]] == [0.0]
    assert len(out["attention_ab"]) == 4 and "ms_bd" not in out["attention_ab"][1]
    assert len(out["train_step"]) == 6
    rows = interleaved_ab.main(["--device", "cpu", "--steps", "1", "--rounds", "2",
                                "--out", str(tmp_path / "i.json")])
    committed = json.loads((ART / "interleaved_ab_r5.json").read_text())
    assert [r["variant"] for r in rows] == list(interleaved_ab.VARIANTS)
    for r in rows:
        assert set(r) - {"runs_as"} == set(committed[0])
        assert r.get("runs_as") == (r["variant"].replace("+rbg", "") if "rbg" in r["variant"]
                                    else None)
        assert len(r["all_chunk_ms"]) == 2


# --- Queue 3's channel check ------------------------------------------------------


def test_jax_ar_oracle_driver_no_longer_gives_its_committed_artifact(tmp_path):
    """The yardstick of the channel check: the JAX package's own
    ``experiments/ar_oracle.py``, run today on the CPU at the committed
    artifact's settings, gives an NMSE bound above
    ``experiments/artifacts/ar_oracle.json``'s (SNR 12: -6.65 dB against
    -6.77). The artifact predates the JAX generator as it stands, so the
    port's channel is held against the driver's output, not the artifact
    (``cli/channel_spread.py``; ROADMAP Queue 3)."""
    _run_jax("ar_oracle.py", "--slot-symbols", "14", "--order", "30", "--snr", "12",
             "--out", str(tmp_path / "ar.json"))
    today = json.loads((tmp_path / "ar.json").read_text())["snr"]["12.0"]["nmse_db"]
    committed = json.loads((ART / "ar_oracle.json").read_text())["snr"]["12.0"]["nmse_db"]
    assert today - committed > 0.05, (today, committed)


def test_channel_spread_summarises_every_key(monkeypatch, tmp_path):
    """``cli/channel_spread.py`` over three oracle keys and two calibration
    keys (the statistics stubbed with values of the keys): each key's row,
    min / max / mean / std across keys, and whether JAX's artifact value
    lies inside, at every SNR of ``ar_oracle.json`` and every speed."""
    from channelestimationtransformer_torch.cli import ar_oracle, channel_spread

    art = json.loads((ART / "ar_oracle.json").read_text())["snr"]
    monkeypatch.setattr(ar_oracle, "oracle_rows", lambda args, device, dataset_key, log: {
        snr: {"nmse_db": r["nmse_db"] + 0.1 * (dataset_key - 1)} for snr, r in art.items()})
    monkeypatch.setattr(calibrate_channel, "fit_speed", lambda speeds, n, device, seed, log: (
        {str(v): {"rms_delta_db": v + seed} for v in speeds}, speeds[0], speeds[0] + seed))
    out = channel_spread.main(["--device", "cpu", "--oracle-keys", "0", "1", "2",
                               "--calibration-keys", "0", "1", "--speeds", "6,30",
                               "--out", str(tmp_path / "s.json")])
    for snr, r in out["ar_oracle"]["spread_db"].items():
        assert r["min"] == pytest.approx(art[snr]["nmse_db"] - 0.1)
        assert r["std"] == pytest.approx(0.1) and r["jax_inside"]
    cal = out["calibration"]
    assert cal["fitted_speed_kmh"]["jax_inside"] and set(cal["rms_delta_db"]) == {"6.0", "30.0"}
    assert cal["rms_delta_db"]["6.0"]["min"] == 6.0 and not cal["rms_delta_db"]["6.0"]["jax_inside"]
