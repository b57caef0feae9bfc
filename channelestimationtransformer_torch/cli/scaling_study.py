"""Scaling-efficiency driver: data-parallel training throughput at 1..N
ranks (the counterpart of ``experiments/scaling_study.py``).

Weak scaling: the per-rank batch and the per-rank dataset shard are fixed,
so perfect scaling is samples/s(N) = N x samples/s(1) (efficiency 1.0).
Each world size N is its own group of N local ranks
(``parallel/launch.py:run_local``), each running ``train_chunk_dp`` on its
shard of random channels ``[samples_per_device x N, seq_len + pred_len + 8,
16]`` (numpy seed 0, as JAX): NCCL with one card a rank on the card, gloo
ranks on the CPU with ``--device cpu``.

    python -m channelestimationtransformer_torch.cli.scaling_study --full-model
    python -m channelestimationtransformer_torch.cli.scaling_study --device cpu --device-counts 1,2

The collective bytes a step are counted from what the port all-reduces
(``parallel/collectives.py:all_reduce_sum.bytes``: the BatchNorm
statistics forward and backward, the loss's power and metrics, the
gradients in one buffer), where JAX parses the compiled HLO. ``--account``
counts them for the flagship at a per-rank batch of 128 and models a
2-rank all-reduce on three links beside the measured flagship step.

The artifact records the platform, the backend and the card count: CPU
ranks share one host's cores, so their "efficiency" is no card number.
``--device-counts`` defaults to 1, 2, 4, 8 on the CPU and to the powers of
two up to the card count on the card (NCCL takes one card a rank);
``--step-ms`` defaults to the step this run measures (JAX's default is a
TPU figure). Writes ``<--out>/scaling.json`` (default ``weights/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset
from ..models.informer import build_informer
from ..parallel.collectives import all_reduce_sum
from ..parallel.launch import join_local, run_local
from ..parallel.mesh import make_mesh
from ..train.trainer import create_train_state, train_chunk_dp
from ._study import add_device_arg

ROOT = Path(__file__).resolve().parents[2]
# A 2-rank ring all-reduce of B bytes moves B bytes over the link between
# the ranks (reduce-scatter B/2 + all-gather B/2); one direction's rate.
LINKS = {"nvlink4_450GBps": 450e9, "pcie5_x16_64GBps": 64e9, "ib_ndr_400gbit": 50e9}
ACCOUNT_BATCH = 128


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Data-parallel weak scaling at 1..N ranks.")
    p.add_argument("--device-counts", default=None)
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--samples-per-device", type=int, default=512)
    p.add_argument("--steps-per-chunk", type=int, default=8)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--full-model", action="store_true",
                   help="the flagship config (default: a small model)")
    p.add_argument("--account", action="store_true",
                   help="also count the flagship step's collective bytes and model the "
                        "2-rank efficiency on three links")
    p.add_argument("--step-ms", type=float, default=None,
                   help="flagship step ms for the --account model (default: measured here)")
    p.add_argument("--out", default="weights")
    add_device_arg(p)
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    return p


def model_config(full: bool) -> InformerConfig:
    if full:
        return InformerConfig()
    return InformerConfig(seq_len=48, label_len=8, pred_len=5, d_model=32, n_heads=4,
                          e_layers=(2, 1), d_layers=2, d_ff=32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(cfg, *, device, per_device_batch, samples_per_device, total_samples, steps, reps):
    """This rank's part of one world size: samples/s of ``train_chunk_dp``
    (rank 0's clock, every chunk ending in a fetch of the loss) and the
    bytes all-reduced by one step."""
    group = make_mesh().get_group("data")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    cfg = dataclasses.replace(cfg, use_pallas=device.type == "cuda")
    state = create_train_state(build_informer(cfg, device=device, seed=0),
                               TrainConfig(batch_size=per_device_batch * n))
    host_h = np.random.default_rng(0).normal(
        size=(total_samples, cfg.seq_len + cfg.pred_len + 8, cfg.enc_in)).astype(np.float32)
    shard = WindowDataset(h=host_h[r * samples_per_device:(r + 1) * samples_per_device],
                          seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=21.0,
                          device=device)
    kwargs = dict(per_device_batch=per_device_batch, label_len=cfg.label_len, group=group)

    def chunk(i, num_steps):
        m = train_chunk_dp(state, shard, num_steps=num_steps,
                           generator=stream_generator(device, 1, i, r), **kwargs)
        return float(m["loss_sum"])

    chunk(0, steps)  # warm: cuDNN and cuBLAS plans, the kernels' first launches
    before = all_reduce_sum.bytes
    chunk(1, 1)
    step_bytes = all_reduce_sum.bytes - before
    dist.barrier(group)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        loss = chunk(2 + i, steps)
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    return {"devices": n, "global_batch": per_device_batch * n,
            "ms_per_step": round(1000 * dt / steps, 4),
            "samples_per_s": round(steps * per_device_batch * n / dt, 1),
            "collective_bytes_per_step": step_bytes, "loss": loss}


def _worker(args):
    device = join_local(resolve_device(args.device))
    counts = [int(c) for c in args.device_counts.split(",")]
    row = _measure(model_config(args.full_model), device=device,
                   per_device_batch=args.per_device_batch,
                   samples_per_device=args.samples_per_device,
                   total_samples=args.samples_per_device * max(counts),
                   steps=args.steps_per_chunk, reps=args.reps)
    if dist.get_rank() == 0:
        Path(args.worker).write_text(json.dumps(row))
    dist.destroy_process_group()


def _spawn(args, argv, nprocs) -> dict:
    """One world size as ``nprocs`` local ranks of this driver."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "row.json"
        cmd = [sys.executable, "-m", "channelestimationtransformer_torch.cli.scaling_study",
               *argv, "--worker", str(out)]
        env = {"PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT),
                                                           os.environ.get("PYTHONPATH")]))}
        run_local(cmd, nprocs, timeout=3600.0, env=env,
                  threads=1 if args.device == "cpu" else None)
        return json.loads(out.read_text())


def main(argv=None) -> dict:
    """Measure every world size; returns the result written to ``--out``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.worker:
        _worker(args)
        return {}
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if args.device_counts is None:
        counts = [1, 2, 4, 8] if device.type == "cpu" else [
            c for c in (1, 2, 4, 8) if c <= cards]
        argv += ["--device-counts", ",".join(map(str, counts))]
    else:
        counts = sorted(int(c) for c in args.device_counts.split(","))
    if device.type == "cuda" and counts[-1] > cards:
        raise ValueError(f"{counts[-1]} ranks need {counts[-1]} cards (NCCL takes one card a "
                         f"rank); this machine has {cards}")
    rows = []
    for d in counts:
        row = _spawn(args, argv, d)
        base = rows[0] if rows else row
        key = "efficiency_vs_1dev" if counts[0] == 1 else f"efficiency_vs_{counts[0]}dev"
        row[key] = round(row["samples_per_s"] / (row["devices"] * base["samples_per_s"]
                                                 / base["devices"]), 3)
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"platform": device.type, "backend": "nccl" if device.type == "cuda" else "gloo",
              "device_name": torch.cuda.get_device_name(0) if cards else "cpu",
              "device_count": cards, "weak_scaling": rows}
    if device.type == "cpu":
        result["weak_scaling_note"] = (
            "HOST-CONTENTION TABLE, not a scaling result: N gloo ranks time-share one "
            "host's CPU cores, so efficiency_vs_1dev decays toward 1/N. No card ran.")
    if args.account:
        # The flagship's step on one rank (the last occurrence of a flag wins).
        acct = _spawn(args, argv + ["--full-model", "--device-counts", "1", "--per-device-batch",
                                    str(ACCOUNT_BATCH), "--samples-per-device",
                                    str(4 * ACCOUNT_BATCH), "--steps-per-chunk", "2",
                                    "--reps", "2"], 1)
        step_ms = args.step_ms if args.step_ms is not None else acct["ms_per_step"]
        bytes_step = acct["collective_bytes_per_step"]
        result["collective_accounting"] = {
            "config": "InformerConfig() flagship", "per_device_batch": ACCOUNT_BATCH,
            "bytes_per_step": bytes_step, "step_ms": step_ms,
            "step_ms_source": "--step-ms" if args.step_ms is not None else
            f"measured here ({device.type}, one rank)",
            "efficiency_model": {
                name: {"t_comm_ms": round(bytes_step / bw * 1e3, 4),
                       "efficiency_2rank_no_overlap": round(
                           step_ms / (step_ms + bytes_step / bw * 1e3), 4)}
                for name, bw in LINKS.items()}}
        print(json.dumps(result["collective_accounting"], indent=1), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "scaling.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return result


if __name__ == "__main__":
    main()
