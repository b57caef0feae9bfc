"""The port's launch helpers, data-parallel ``Trainer`` and scaling driver
(the counterparts of ``tests/test_launch_distributed.py`` and of
``experiments/scaling_study.py``), on the CPU.

Multi-process cases run as gloo ranks of ``tests/torch_parallel_worker.py``
(one thread each, each group joined within its own timeout by
``parallel/launch.py:run_local``); the scaling driver starts its own groups
the same way. The JAX driver is not imported: its flags are read from its
source, as ``tests/test_torch_cli.py`` reads the others'.
"""

import ast
import json
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.cli import scaling_study
from channelestimationtransformer_torch.parallel import launch

from test_torch_cli import _jax_flags, _port_flags
from torch_parallel_worker import spawn


def test_two_processes_rendezvous_from_the_environment(tmp_path):
    """JAX test_two_process_distributed_psum: two real OS processes join one
    gloo group through ``initialize_distributed`` from the torchrun
    variables, ``per_host_batch(256) == 128`` in each, and an all-reduce of
    the ranks' shards (4 x 1 and 4 x 2) gives 12 (asserted in the ranks)."""
    outs = spawn(tmp_path, ["launch_env"], 2)
    assert [out["launch_env"]["total"] for out in outs] == [12.0, 12.0]


ENVS = [
    # (environment, arguments, the (address, world size, rank) init_group gets)
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "WORLD_SIZE": "8", "RANK": "5",
      "MASTER_ADDR": "h", "MASTER_PORT": "7"}, {}, ("h:7", 4, 2)),
    ({"WORLD_SIZE": "8", "RANK": "5", "MASTER_ADDR": "h", "MASTER_PORT": "7"}, {},
     ("h:7", 8, 5)),
    ({"WORLD_SIZE": "8", "RANK": "5", "MASTER_ADDR": "h", "MASTER_PORT": "7"},
     dict(coordinator_address="c:1", num_processes=3, process_id=1), ("c:1", 3, 1)),
]


@pytest.mark.parametrize("env,kwargs,want", ENVS)
def test_initialize_distributed_reads_arguments_then_slurm_then_torchrun(
        monkeypatch, env, kwargs, want):
    """JAX ``launch.py:17-46``'s order: the arguments, then SLURM's
    variables, then torchrun's in JAX's own variables' place."""
    for name in ("SLURM_NTASKS", "SLURM_PROCID", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(launch, "init_group",
                        lambda *args, device=None: calls.append((args, device)))
    assert launch.initialize_distributed(device="cpu", **kwargs) is True
    assert calls == [(want, "cpu")]


def test_one_process_initializes_nothing(monkeypatch):
    """One process is a no-op, as JAX's; many with no address raise."""
    for name in ("SLURM_NTASKS", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(launch, "init_group", lambda *a, **k: pytest.fail("initialized"))
    assert launch.initialize_distributed(device="cpu") is False
    assert launch.initialize_distributed(num_processes=1, device="cpu") is False
    assert launch.per_host_batch(256) == 256
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        launch.initialize_distributed(num_processes=2, device="cpu")


def test_run_local_stops_the_group_when_a_rank_fails():
    """A rank that fails is reported at once, and the rank left waiting
    (here: sleeping) is killed, not waited for."""
    script = "import os, sys, time; sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        launch.run_local([sys.executable, "-c", script], 2, timeout=50)
    assert time.monotonic() - t0 < 30


def test_run_local_kills_a_group_past_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        launch.run_local([sys.executable, "-c", "import time; time.sleep(60)"], 2, timeout=2)
    assert time.monotonic() - t0 < 30


def test_trainer_with_a_mesh_resumes_bit_exactly_at_world_2(tmp_path):
    """``Trainer(mesh=...)`` on 2 ranks (dropout 0.1): a run stopped after
    epoch 2 and resumed from rank 0's checkpoint ends with every tensor of
    the model equal to an uninterrupted run's, on both ranks; the last
    validation NMSE is a single process's ``eval_chunk`` with the same
    generator; batch 3 on 2 ranks raises JAX's divisibility error."""
    outs = spawn(tmp_path, ["trainer_resume"], 2)
    refused = outs[0]["trainer_resume"]["refused"]
    assert refused == "batch_size 3 not divisible by data-axis size 2"
    assert outs[0]["trainer_resume"]["nmse"] == outs[1]["trainer_resume"]["nmse"]


def test_scaling_study_flags_match_the_jax_driver(monkeypatch):
    """Every flag of ``experiments/scaling_study.py``, with its type, apart
    from three defaults: ``--device-counts`` (the card count bounds the
    ranks on the card), ``--step-ms`` (JAX's is a TPU step) and ``--out``
    (``weights``, never the JAX package's artifacts); the port adds
    ``--device`` and a hidden ``--worker``."""
    real = ast.literal_eval  # JAX's --out default is a path expression
    monkeypatch.setattr(ast, "literal_eval",
                        lambda n: real(n) if not isinstance(n, ast.Call) else "<path>")
    want = _jax_flags("experiments/scaling_study.py")
    assert want["--out"]["default"] == "<path>"
    got = _port_flags(scaling_study.build_parser())
    assert set(got) == set(want) | {"--device", "--worker"}
    changed = {"--device-counts": None, "--step-ms": None, "--out": "weights"}
    for flag in want:
        if flag in changed:
            assert got[flag] == dict(want[flag], default=changed[flag]), flag
        else:
            assert got[flag] == want[flag], flag


def test_scaling_study_runs_gloo_ranks_and_says_so(tmp_path, capsys):
    """The driver at a tiny size on 1 and 2 gloo ranks: a row a world size
    with its samples/s and efficiency, the collective bytes a step (the
    same at every world size: each rank all-reduces the same buffers), and
    the platform, backend and card count that keep CPU ranks from being
    read as card numbers."""
    result = scaling_study.main(["--device", "cpu", "--device-counts", "1,2",
                                 "--per-device-batch", "2", "--samples-per-device", "8",
                                 "--steps-per-chunk", "2", "--reps", "1",
                                 "--out", str(tmp_path)])
    assert json.loads((tmp_path / "scaling.json").read_text()) == result
    assert (result["platform"], result["backend"], result["device_count"]) == ("cpu", "gloo", 0)
    assert "not a scaling result" in result["weak_scaling_note"]
    rows = result["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["global_batch"] for r in rows] == [2, 4]
    assert rows[0]["efficiency_vs_1dev"] == 1.0 and rows[1]["efficiency_vs_1dev"] > 0
    n_params = sum(p.numel() for p in scaling_study.build_informer(
        scaling_study.model_config(False), device="cpu").parameters())
    assert rows[0]["collective_bytes_per_step"] == rows[1]["collective_bytes_per_step"]
    assert rows[0]["collective_bytes_per_step"] > 4 * n_params  # gradients and the rest
