"""The comparison that decides ``correct`` fails what it must: the control
(the reference put in the program's place, a precision below the
configuration's) and each fault a cell can have, planted in the program
under a run whose look for a chip is skipped. Each cell's own limits
(``limits/<cell>.json``) judge; the CPU runs shrink the batch and the
stored samples, which the card test below does not."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, check, draws, faults, workload
from portbench.manifest import Manifest
from portbench.program import Program

HARNESS = Path(__file__).resolve().parents[1]
REPO = HARNESS.parent
CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
# A serving cell of the flagship at batch 8, with the limits calibrated on the
# card for its serving at batch 256: no cell of the benchmark serves yet.
SERVE = "flagship-f32.serve-b8"
SERVE_LIMITS = {"nmse": {"limit": 5e-09}, "worst_window": {"limit": 1e-04}}
KINDS = {**{c: Manifest().traffic(Manifest().cell(c)["traffic"])["kind"] for c in CELLS},
         SERVE: "serve"}


@pytest.fixture(scope="module")
def small(tmp_path_factory) -> Manifest:
    """The benchmark with every cell's batch cut to 8, on the CPU."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(HARNESS, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    for path in (root / "portbench/configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["data"]["samples"] = 64
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench/traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(batch=8)
        path.write_text(json.dumps(traffic))
    (root / "portbench/traffic/serve-b8.json").write_text(json.dumps({"kind": "serve",
                                                                       "batch": 8}))
    (root / f"portbench/limits/{SERVE}.json").write_text(json.dumps({"numbers": SERVE_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": SERVE, "config": "flagship-f32", "traffic": "serve-b8",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Manifest(root, root / "portbench")


def _run(manifest, cell, seed):
    return workload.run(manifest, cell, seed=seed, seconds=0.1, trace=False, device="cpu",
                        t_start=time.perf_counter(), log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS + [SERVE])
def test_a_sound_run_is_correct(small, cell):
    assert _run(small, cell, 2**35 + 1)["correct"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, kind in KINDS.items()
                                        for f in faults.FAULTS[kind]])
def test_each_fault_comes_out_not_correct(small, cell, fault):
    with faults.plant(fault, KINDS[cell]):
        result = _run(small, cell, 2**35 + 2)
    assert not result["correct"]


def _fails(cell, numbers) -> bool:
    return any(not numbers[n] <= e["limit"]
               for n, e in cell.limits.items())


def test_the_float8_control_is_not_correct():
    """A bfloat16 configuration's control (float8 e4m3 products) lies
    farther from the float32 reference than the program in bfloat16 does:
    at a tiny width on the CPU, one serving request of 8 windows."""
    from portbench.reference import informer_stack as ref

    cfg = json.loads((HARNESS / "configs" / "flagship-f32.json").read_text())
    cfg["model"].update(d_model=32, n_heads=4, d_ff=16, seq_len=24, e_layers=[2, 1],
                        d_layers=2, dtype="bfloat16")
    cfg["data"].update(samples=32, slots=32)
    spec = ref.parameter_spec(cfg["model"])
    h = draws.dataset(cfg, 9, "cpu")
    w0 = draws.weights(spec, 9, "cpu")
    ref_cfg = {**cfg["model"], "snr_db": cfg["data"]["snr_db"]}
    r = draws.serve_draws(cfg, 8, 1, 9, "cpu")[0]
    want = ref.predict(w0, ref_cfg, h, *r, ref.Precision("float32"))
    program = Program(cfg, draws.weights(spec, 9, "cpu"), h, torch.device("cpu")).serve(8, *r)
    control = ref.predict(w0, ref_cfg, h, *r, ref.Precision(calibrate.CONTROL["bfloat16"]))
    sound = check.serve_numbers([program.float()], [want])["nmse"]
    assert check.serve_numbers([control], [want])["nmse"] > 3 * sound


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    c = workload.Cell(Manifest(), cell)
    assert _fails(c, calibrate.control_numbers(c, 2**35 + 4, torch.device("cuda")))
