"""``BENCHMARK.json`` keeps to its schema, and the harness is driven by
data: a configuration, a traffic mix and a metric reader added as new files
are found by name, with no file of the harness edited."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench.manifest import Manifest

HARNESS = Path(__file__).resolve().parents[1]
REPO = HARNESS.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["config"] for c in BENCH["workloads"]] + [c["traffic"] for c in BENCH["workloads"]]
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(c["name"] for c in BENCH["workloads"])) == len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.fullmatch(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS and m["better"] in ("lower", "higher")


def test_every_cell_has_its_files_and_metrics():
    manifest = Manifest()
    for w in BENCH["workloads"]:
        manifest.config(w["config"])
        manifest.traffic(w["traffic"])
        assert manifest.limits(w["name"])["numbers"]
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer(w["name"])
        assert layer
        for m in layer:
            assert callable(manifest.reader(m["name"]))


def test_every_metric_moves_what_its_cells_report():
    manifest = Manifest()
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in manifest.end_to_end(cell)}


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(HARNESS, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(tmp_path / "portbench")
    cfg = json.loads((HARNESS / "configs" / "flagship-f32.json").read_text())
    cfg["model"].update(d_model=32, n_heads=4, d_ff=16, seq_len=24, e_layers=[2, 1],
                        d_layers=1)
    cfg["data"].update(samples=32, slots=32)
    (tmp_path / "portbench/configs/tiny-f32.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/serve-b4.json").write_text(
        json.dumps({"kind": "serve", "batch": 4}))
    # a new traffic kind is a new loop file beside the others
    (tmp_path / "portbench/loops/serve_again.py").write_text(
        (HARNESS / "loops" / "serve.py").read_text())
    (tmp_path / "portbench/traffic/again-b4.json").write_text(
        json.dumps({"kind": "serve_again", "batch": 4}))
    limits = json.dumps({"numbers": {"nmse": {"limit": 1e-9}, "worst_window": {"limit": 1e-4}}})
    for cell in ("tiny-f32.serve-b4", "tiny-f32.again-b4"):
        (tmp_path / f"portbench/limits/{cell}.json").write_text(limits)
    (tmp_path / "portbench/metrics/windows_per_request.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-f32", "source": "https://arxiv.org/abs/2012.07436",
                             "file": "portbench/configs/tiny-f32.json", "reduced": [],
                             "why": "a test"})
    serve_cells = [f"tiny-f32.{mix}" for mix in ("serve-b4", "again-b4")]
    for cell in serve_cells:
        bench["workloads"].append({"name": cell, "config": "tiny-f32",
                                   "traffic": cell.split(".", 1)[1], "chips": 1, "why": "a test"})
    bench["end_to_end"] += [
        {"name": "serve_samples_per_s", "unit": "samples/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": serve_cells},
        {"name": "serve_ms_p95", "unit": "ms", "better": "lower", "bound": 0.05,
         "source": "host_clock", "workloads": serve_cells}]
    bench["per_layer"].append({"name": "windows_per_request.serve", "unit": "windows/req",
                               "better": "higher", "source": "program_counter",
                               "layer": "trainer loop and host dispatch",
                               "moves": "serve_samples_per_s",
                               "workloads": ["tiny-f32.serve-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    manifest = Manifest(tmp_path, tmp_path / "portbench")
    assert manifest.config("tiny-f32")["model"]["d_model"] == 32
    assert manifest.traffic("serve-b4")["batch"] == 4
    assert [m["name"] for m in manifest.per_layer("tiny-f32.serve-b4")] == [
        "windows_per_request.serve"]
    from portbench import workload

    for trace in (False, True):
        result = workload.run(manifest, "tiny-f32.serve-b4", seed=2**40 + 3, seconds=0.2,
                              trace=trace, device="cpu", t_start=time.perf_counter(),
                              log=lambda msg: None)
        assert result["correct"]
        if trace:
            assert result["metrics"]["windows_per_request.serve"]["value"] == 4.0
        else:
            assert set(result["metrics"]) == {"serve_samples_per_s", "serve_ms_p95", "setup_s"}
    cell = workload.Cell(manifest, "tiny-f32.again-b4")
    assert cell.loop.__file__ == str(tmp_path / "portbench/loops/serve_again.py")
    result = workload.run(manifest, "tiny-f32.again-b4", seed=7, seconds=0.2, trace=False,
                          device="cpu", t_start=time.perf_counter(), log=lambda msg: None)
    assert result["correct"] and result["attempted"] >= 1
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_traffic_of_each_cell_is_data(name):
    cell = next(c for c in BENCH["workloads"] if c["name"] == name)
    traffic = json.loads((HARNESS / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HARNESS / "loops" / f"{traffic['kind']}.py").is_file()
    assert not list((HARNESS / "traffic").glob("*.py"))
