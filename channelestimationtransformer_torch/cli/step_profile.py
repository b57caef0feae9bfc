"""The flagship training step taken apart by ablation (the counterpart of
``experiments/step_profile.py``, flag for flag).

Thirteen rows, each a configuration's median ms a step over ``--chunks``
chunks of ``--steps`` steps (JAX's 10) after two warm-up chunks, by the
host clock to the chunk's loss fetch (a synchronise), as
``utils/profiling.time_fn`` times a call:

- the canonical step (bf16, the bd kernels) and its ``fuse_qkv`` variant,
  against the f32 plain path; the ProbSparse model in both;
- forward only (``eval_chunk``) against forward + backward + Adam;
- no distilling pyramid, no dropout, one encoder instead of the stack;
- batch 512 and 1024 (and 1024 fused) at the same per-sample work.

``vs_canonical`` gives each ablation's share of the canonical step, and
``batch_scaling_note`` whether 4x the batch costs near 4x the time. JAX's
``_rbg`` rows (its TPU key implementation) run with the port's
``torch.Generator`` streams, as every row here::

    python -m channelestimationtransformer_torch.cli.step_profile --out weights/step_profile.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset
from ..models.informer import build_informer
from ..train.trainer import create_train_state, eval_chunk, train_chunk
from ._study import add_device_arg

SAMPLES = 4096  # a 4,096 x 100 x 16 normal dataset, as JAX's
# The flagship (the tests shrink it) and its batch; the batch rows take 2x and 4x.
MODEL_KWARGS: dict = {}
BATCH = 256


def measure(cfg: InformerConfig, *, batch: int, chunks: int, steps: int, device,
            fwd_only: bool = False) -> dict:
    h = np.random.default_rng(1).normal(size=(SAMPLES, 100, cfg.enc_in))
    ds = WindowDataset(h=torch.as_tensor(h, dtype=torch.float32, device=device),
                       seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=21.0, device=device)
    state = create_train_state(build_informer(cfg, device=device, seed=0),
                               TrainConfig(batch_size=batch))

    def chunk(i):
        gen = stream_generator(device, 2, i)
        if fwd_only:
            return float(eval_chunk(state.model, ds, num_batches=steps, batch_size=batch,
                                    label_len=cfg.label_len, generator=gen)["nmse"])
        return float(train_chunk(state, ds, num_steps=steps, batch_size=batch,
                                 label_len=cfg.label_len, generator=gen)["loss_sum"])

    for i in range(2):
        chunk(i)
    times = []
    for i in range(chunks):
        t0 = time.perf_counter()
        chunk(10 + i)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1000 / steps
    return {"ms_per_step": round(ms, 3), "samples_per_s": round(batch / (ms / 1000), 1)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The flagship training step by ablation.")
    p.add_argument("--chunks", type=int, default=7)
    p.add_argument("--out", default="weights/step_profile.json")
    p.add_argument("--steps", type=int, default=10, help="steps (or batches) a chunk")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    flagship = InformerConfig(**MODEL_KWARGS)
    canon = dataclasses.replace(flagship, dtype="bfloat16", use_pallas=True)
    rows = {}

    def run(name, cfg, *, batch=BATCH, fwd_only=False):
        try:
            rows[name] = measure(cfg, batch=batch, chunks=args.chunks, steps=args.steps,
                                 device=device, fwd_only=fwd_only)
        except RuntimeError as exc:
            rows[name] = {"error": str(exc)[:200]}
        print(json.dumps({name: rows[name]}), flush=True)

    run("canonical_bf16_bd_rbg", canon)
    run("canonical_fuse_qkv", dataclasses.replace(canon, fuse_qkv=True))
    run("baseline_f32_xla", flagship)
    # ProbSparse rows: the flagship's alternate attention mode, against the
    # reference's A100 prob baseline of 2,230 samples/s.
    run("prob_bf16_rbg", dataclasses.replace(canon, attn="prob"))
    run("prob_f32_xla", dataclasses.replace(flagship, attn="prob"))
    run("fwd_only_canonical", canon, fwd_only=True)
    run("fwd_only_prob", dataclasses.replace(canon, attn="prob"), fwd_only=True)
    run("no_distil", dataclasses.replace(canon, distil=False))
    run("no_dropout", dataclasses.replace(canon, dropout=0.0))
    run("single_stack", dataclasses.replace(canon, e_layers=tuple(canon.e_layers[:1])))
    run("batch_512", canon, batch=2 * BATCH)
    run("batch_1024", canon, batch=4 * BATCH)
    run("batch_1024_fuse", dataclasses.replace(canon, fuse_qkv=True), batch=4 * BATCH)

    base = rows.get("canonical_bf16_bd_rbg", {}).get("ms_per_step")
    summary = {"rows": rows, "steps_per_chunk": args.steps}
    if base:
        shares = {}
        for k in ("fwd_only_canonical", "no_distil", "no_dropout", "single_stack",
                  "canonical_fuse_qkv"):
            v = rows.get(k, {}).get("ms_per_step")
            if v:
                shares[k] = {"delta_ms": round(base - v, 3),
                             "delta_pct": round(100 * (base - v) / base, 1)}
        summary["vs_canonical"] = shares
        b1024 = rows.get("batch_1024", {}).get("ms_per_step")
        if b1024:
            summary["batch_scaling_note"] = (
                f"4x batch costs {round(b1024 / base, 2)}x time -> "
                f"{'latency-floor' if b1024 / base < 2.5 else 'compute'}-bound at batch 256")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary.get("vs_canonical", {})))
    return summary


if __name__ == "__main__":
    main()
