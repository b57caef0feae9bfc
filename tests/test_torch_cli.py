"""The port's command-line drivers against the JAX package's
(``experiments/train_informer.py``, ``experiments/generate_dataset.py``).

The drivers run here on the CPU (``--device cpu``) with the shrunken model
of the JAX recipe (d_model 32, d_ff 32, one encoder and one decoder layer)
and 64 train and 64 val samples. The JAX drivers are not imported (they
switch on JAX's persistent compilation cache at import): their flags are
read from their source, and the run name is built with their formula
(``experiments/train_informer.py:145-161``).
"""

import ast
import json
import pathlib
import pickle
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.data.windows import WindowDataset as JaxWindowDataset

from channelestimationtransformer_torch.channel.cdl import CDLModel
from channelestimationtransformer_torch.channel.dataset import (
    generate_beamformed_dataset,
    train_val_split,
)
from channelestimationtransformer_torch.cli import generate_dataset, train_informer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--d-model", "32", "--d-ff", "32", "--e-layers", "1",
         "--d-layers", "1", "--train-samples", "64", "--val-samples", "64",
         "--batch-size", "32", "--snr", "20", "--calibrated", "--ue-speed-kmh", "5"]
# experiments/train_informer.py:226-234
JAX_RESULT_KEYS = {"name", "snr", "epochs", "final_val_nmse", "final_val_nmse_db",
                   "final_val_split", "history_nmse"}


def _jax_flags(path):
    """``--flag -> {default, type, choices, nargs, action}`` of every
    ``add_argument`` call in a JAX driver's source."""
    flags = {}
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            action = ast.literal_eval(kw["action"]) if "action" in kw else None
            flags[node.args[0].value] = {
                "default": (ast.literal_eval(kw["default"]) if "default" in kw
                            else (False if action == "store_true" else None)),
                "type": kw["type"].id if "type" in kw else None,
                "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                "nargs": ast.literal_eval(kw["nargs"]) if "nargs" in kw else None,
                "action": action,
            }
    return flags


def _port_flags(parser):
    out = {}
    for a in parser._actions:
        if a.option_strings[0] == "-h":
            continue
        store_true = a.const is True and a.nargs == 0
        out[a.option_strings[0]] = {
            "default": a.default,
            "type": a.type.__name__ if a.type else None,
            "choices": list(a.choices) if a.choices else None,
            "nargs": a.nargs if not store_true else None,
            "action": "store_true" if store_true else None,
        }
    return out


@pytest.mark.parametrize("driver,cli,left_out", [
    ("experiments/train_informer.py", train_informer, {"--prng"}),
    ("experiments/generate_dataset.py", generate_dataset, set()),
])
def test_flags_match_the_jax_driver(driver, cli, left_out):
    """Every flag of the JAX driver, with its default, type, choices and
    nargs, apart from ``--prng`` (JAX's key implementation); the port adds
    ``--device`` only."""
    want, got = _jax_flags(driver), _port_flags(cli.build_parser())
    assert set(got) == (set(want) - left_out) | {"--device"}
    for flag in set(want) - left_out:
        assert got[flag] == want[flag], flag
    assert got["--device"]["default"] is None


def jax_run_name(argv):
    """The JAX driver's run name for ``argv`` (its formula, with the port's
    parser standing in for its own; the flags are the same, test above)."""
    args = train_informer.parse_args(argv)
    ue_speed = (args.ue_speed_kmh if args.ue_speed_kmh is not None
                else (5.5 if args.calibrated else 30.0))
    cfg = JaxInformerConfig(
        seq_len=args.seq_len, label_len=args.label_len, pred_len=args.pred_len,
        d_model=args.d_model, n_heads=args.n_heads, e_layers=tuple(args.e_layers),
        d_layers=args.d_layers, d_ff=args.d_ff, dropout=args.dropout, attn=args.attn,
        distil=not args.no_distil, pre_norm=args.pre_norm, dtype=args.dtype,
        use_pallas=args.use_pallas)
    prng = "threefry2x32"
    return (
        f"ei_{cfg.enc_in}_di_{cfg.dec_in}_co_{cfg.c_out}_sl_{cfg.seq_len}"
        f"_ll_{cfg.label_len}_pl_{cfg.pred_len}_f_{cfg.factor}_dm_{cfg.d_model}"
        f"_nh_{cfg.n_heads}_el_{list(cfg.e_layers)}_dl_{cfg.d_layers}"
        f"_df_{cfg.d_ff}_do_{cfg.dropout}_at_{cfg.attn}_em_fixed_ac_gelu_{int(args.snr)}"
        + ("_cal" if args.calibrated else
           (f"_ss{args.slot_symbols}" if args.slot_symbols != 75 else ""))
        + (f"_v{ue_speed:g}"
           if (args.ue_speed_kmh is not None if args.calibrated
               else ue_speed != 30.0) else "")
        + ("_prenorm" if args.pre_norm else "")
        + ("_bf16" if args.dtype == "bfloat16" else "")
        + ("_rbg" if prng == "rbg" else "")
        + ("_pallas" if args.use_pallas else "")
        + ("_nodistil" if args.no_distil else "")
        + (f"_{args.tag}" if args.tag else "")
    )


@pytest.mark.parametrize("argv", [
    [],
    ["--calibrated"],
    ["--calibrated", "--ue-speed-kmh", "30", "--use-pallas", "--tag", "x"],
    ["--ue-speed-kmh", "5", "--slot-symbols", "14", "--pre-norm", "--dtype", "bfloat16"],
    ["--no-distil", "--e-layers", "2", "--snr", "12.5"],
])
def test_run_name_is_the_jax_drivers(argv):
    args = train_informer.parse_args(argv)
    ue = (args.ue_speed_kmh if args.ue_speed_kmh is not None
          else (5.5 if args.calibrated else 30.0))
    cfg = train_informer.InformerConfig(
        seq_len=args.seq_len, label_len=args.label_len, pred_len=args.pred_len,
        d_model=args.d_model, n_heads=args.n_heads, e_layers=tuple(args.e_layers),
        d_layers=args.d_layers, d_ff=args.d_ff, dropout=args.dropout, attn=args.attn,
        distil=not args.no_distil, pre_norm=args.pre_norm, dtype=args.dtype,
        use_pallas=args.use_pallas)
    assert train_informer.run_name(args, cfg, ue) == jax_run_name(argv)


EPOCH_LINE = re.compile(r"^\| epoch +\d+ \| +\d+/ +\d+ batches \| lr \S+ \| ms/batch +\S+ \| "
                        r"loss \S+  \| Loss pred_len( +\d: +\S+){5}$")
END_LINE = re.compile(r"^\| end of epoch +(\d+) \| time: +\S+s \| valid loss (\S+) \| "
                      r"Loss pred len( +\d: +\S+){5}$")


def _run(argv, capsys):
    result = train_informer.main(argv)
    return result, capsys.readouterr().out.splitlines()


def test_train_informer_on_cpu_prints_and_writes_the_jax_drivers_output(tmp_path, capsys):
    argv = SMALL + ["--epochs", "1", "--steps-per-epoch", "2", "--log-every", "1",
                    "--checkpoint-every", "1", "--out", str(tmp_path)]
    result, lines = _run(argv, capsys)
    name = jax_run_name(argv)
    assert lines[0] == f"Model_name:  {name}"
    assert lines[1] == "Using device: cpu"
    assert re.fullmatch(r"Dataset generated in \S+s \(train \(64, 100, 16\), "
                        r"val \(64, 100, 16\)\)", lines[2])
    assert sum(bool(EPOCH_LINE.match(x)) for x in lines) == 1  # the last chunk is not logged
    ends = [END_LINE.match(x) for x in lines if END_LINE.match(x)]
    assert [m.group(1) for m in ends] == ["0"]
    assert lines.count("-" * 89) == 2
    final = json.loads(lines[-1])
    assert set(final) == JAX_RESULT_KEYS - {"history_nmse"}
    on_disk = json.loads((tmp_path / f"result_{name}.json").read_text())
    assert set(on_disk) == JAX_RESULT_KEYS and on_disk == result
    assert on_disk["name"] == name and on_disk["epochs"] == 1 and on_disk["snr"] == 20.0
    assert len(on_disk["final_val_split"]) == 5 and len(on_disk["history_nmse"]) == 1
    assert np.isfinite(on_disk["final_val_nmse"])
    assert on_disk["final_val_nmse_db"] == pytest.approx(10 * np.log10(on_disk["final_val_nmse"]))
    assert float(ends[0].group(2)) == pytest.approx(np.mean(on_disk["final_val_split"]))
    assert (tmp_path / f"tmodel_{name}_1.pt").exists()


def test_train_informer_resume_is_step_exact_and_preload_restarts(tmp_path, capsys):
    """``--resume`` with no checkpoint starts afresh; with one it continues
    from the newest checkpoint's epoch with its optimizer: one epoch, then a
    resumed second, equals two epochs straight (constant lr, so the schedule
    does not depend on the epoch count). ``--preload`` fine-tunes: its
    weights, a fresh optimizer, epoch 0."""
    common = SMALL + ["--steps-per-epoch", "2", "--log-every", "2", "--checkpoint-every", "1",
                      "--lr-schedule", "constant"]
    straight, _ = _run(common + ["--epochs", "2", "--out", str(tmp_path / "a")], capsys)
    _, lines = _run(common + ["--epochs", "1", "--resume", "--out", str(tmp_path / "b")], capsys)
    assert "No checkpoint found to preload" in lines
    resumed, lines = _run(common + ["--epochs", "2", "--resume", "--out", str(tmp_path / "b")],
                          capsys)
    ckpt = tmp_path / "b" / f"tmodel_{resumed['name']}_1.pt"
    assert f"Preloading model {ckpt} (epoch 1)" in lines
    assert [END_LINE.match(x).group(1) for x in lines if END_LINE.match(x)] == ["1"]
    assert resumed["history_nmse"] == straight["history_nmse"][1:]
    assert resumed["final_val_split"] == straight["final_val_split"]

    _, lines = _run(common + ["--epochs", "1", "--preload", "latest",
                              "--out", str(tmp_path / "b")], capsys)
    assert f"Preloading model {tmp_path / 'b' / ckpt.name.replace('_1.pt', '_2.pt')} (epoch 2)" \
        in lines
    assert [END_LINE.match(x).group(1) for x in lines if END_LINE.match(x)] == ["0"]


def test_train_informer_unported_options_raise(tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="item 14"):
        train_informer.main(SMALL + ["--tensorboard", "--out", str(tmp_path)])
    assert "Dataset generated" not in capsys.readouterr().out  # refused before any work


def _gen(tmp_path, *extra):
    generate_dataset.main(["--device", "cpu", "--num-samples", "10", "--num-slots", "20",
                           "--num-bs-ant", "16", "--out-dir", str(tmp_path), *extra])


def test_generate_dataset_writes_reference_pickles_jax_reads(tmp_path, capsys):
    _gen(tmp_path)
    train_path = tmp_path / "Seq_Len_20_Beamforming2_CDLB.pickle"
    val_path = tmp_path / "Seq_Len_20_Beamforming2_CDLB__validate.pickle"
    model = CDLModel(num_bs_ant=16)
    h = generate_beamformed_dataset(0, model=model, num_samples=10, num_slots=20, device="cpu")
    want_train, want_val = train_val_split(h.numpy())
    for path, want, n in ((train_path, want_train, 8), (val_path, want_val, 2)):
        with open(path, "rb") as f:
            arr = pickle.load(f)
        assert arr.dtype == np.complex64 and arr.shape == (n, 20, 2, 4)
        ds = JaxWindowDataset.from_pickle(str(path), seq_len=10, pred_len=5, snr_db=20.0)
        np.testing.assert_array_equal(np.asarray(ds.h), want.reshape(n, 20, 16))
    assert f"Wrote {train_path}: (8, 20, 2, 4)" in capsys.readouterr().out
    _gen(tmp_path)  # appends, as the reference's post-MATLAB script
    with open(train_path, "rb") as f:
        assert pickle.load(f).shape == (16, 20, 2, 4)
    assert f"Wrote {val_path}: (4, 20, 2, 4)" in capsys.readouterr().out


def test_generate_dataset_npz(tmp_path):
    _gen(tmp_path, "--npz", "--speed-kmh", "5", "--slot-symbols", "14", "--seed", "3")
    z = np.load(tmp_path / "Seq_Len_20_Beamforming_CDLB.npz")
    model = CDLModel(num_bs_ant=16, ue_speed_ms=5 / 3.6, sampling_frequency=120e3 / 14)
    h = generate_beamformed_dataset(3, model=model, num_samples=10, num_slots=20,
                                    device="cpu").numpy().reshape(10, 20, 16)
    assert z["train"].shape == (8, 20, 16) and z["val"].shape == (2, 20, 16)
    np.testing.assert_array_equal(np.concatenate([z["train"], z["val"]]), h)


def test_latest_checkpoint_finds_run_names_with_brackets(tmp_path):
    """Run names hold the e_layers list (``el_[4, 3]``), which a glob reads
    as a character class: the JAX package's ``latest_checkpoint`` globs and
    so finds no checkpoint of such a run (ROADMAP Queue 3). The port's
    matches by regex on the escaped name."""
    from channelestimationtransformer_torch.train.checkpoint import latest_checkpoint

    base = "tmodel_ei_16_el_[4, 3]_dl_3_"
    for name in (f"{base}3.pt", f"{base}12.pt", f"{base}x.pt", "tmodel_ei_16_el_4_99.pt"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path), base) == str(tmp_path / f"{base}12.pt")
    assert latest_checkpoint(str(tmp_path / "missing"), base) is None
