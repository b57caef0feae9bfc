"""Scale demo: training throughput and the share of the card's peak at six
model sizes (the counterpart of ``experiments/scale_demo.py``).

The reference's architecture is tiny (d_model 128, d_ff 64): its training
step is latency-bound and a utilisation figure says little there. This
driver trains the same InformerStack at larger widths (``SIZES``, JAX
``:42-52``) through the port's ``train_chunk`` on random channels
``[4096, seq_len + 10, 16]`` (numpy seed 0) and reports, a size: ms a step,
samples/s, FLOPs a step and the achieved share of the card's peak.

    python -m channelestimationtransformer_torch.cli.scale_demo             # bf16, six sizes
    python -m channelestimationtransformer_torch.cli.scale_demo --dtype float32 --sizes large xl

FLOPs: XLA's ``cost_analysis`` has no counterpart, so one training step is
counted by ``torch.utils.flop_counter.FlopCounterMode`` on the plain path of
the same config (``use_pallas=False``; the counter cannot see inside the
hand-written kernels). It counts matmuls and convolutions, not elementwise
work. The peak is the H100's (``PEAK_TFLOPS``: dense bf16 on the tensor
cores, f32 on the CUDA cores with TF32 off), not JAX's v5e figure; the share
keeps JAX's key ``mxu_fraction``. On the card the model takes the attention
kernels where they take the shape (``models/attention.py``). A size that
fails raises. Writes ``--out`` (default ``weights/scale_demo.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset, make_batch
from ..models.informer import build_informer
from ..train.trainer import _update, create_train_state, train_chunk
from ._study import add_device_arg

PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}  # H100 SXM dense bf16; f32 without TF32

SIZES = [
    # (name, d_model, d_ff, seq_len, batch)
    ("reference", 128, 64, 90, 256),
    ("medium", 256, 1024, 128, 256),
    ("large", 512, 2048, 256, 128),
    ("xl", 1024, 4096, 256, 64),
    # the same models at batches that amortize per-step fixed costs
    ("large_b512", 512, 2048, 256, 512),
    ("xl_b256", 1024, 4096, 256, 256),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Training throughput at six model sizes.")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--chunks", type=int, default=3)
    p.add_argument("--sizes", nargs="*", default=None, help="subset of config names to run")
    p.add_argument("--out", default="weights/scale_demo.json")
    add_device_arg(p)
    return p


def size_config(d_model: int, d_ff: int, seq_len: int, dtype: str, **kw) -> InformerConfig:
    return InformerConfig(d_model=d_model, d_ff=d_ff, seq_len=seq_len, dtype=dtype, **kw)


def step_flops(cfg: InformerConfig, tc: TrainConfig, ds: WindowDataset) -> float:
    """FLOPs of one training step (forward, backward) of ``cfg`` on the plain
    path, as ``FlopCounterMode`` counts them."""
    device = ds.h.device
    state = create_train_state(
        build_informer(dataclasses.replace(cfg, use_pallas=False), device=device, seed=0), tc)
    gen = stream_generator(device, 1)
    batch = make_batch(ds, tc.batch_size, cfg.label_len, generator=gen)
    counter = FlopCounterMode(display=False)
    with counter:
        _update(state, *batch, gen)
    return float(counter.get_total_flops())


def run_size(name, d_model, d_ff, seq_len, batch, *, dtype, steps, chunks, device, rng) -> dict:
    cfg = size_config(d_model, d_ff, seq_len, dtype, use_pallas=device.type == "cuda")
    tc = TrainConfig(batch_size=batch)
    state = create_train_state(build_informer(cfg, device=device, seed=0), tc)
    n_params = sum(p.numel() for p in state.model.parameters())
    h = rng.normal(size=(4096, seq_len + 10, 16)).astype(np.float32)
    ds = WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=21.0,
                       device=device)
    flops_step = step_flops(cfg, tc, ds)
    kwargs = dict(num_steps=steps, batch_size=batch, label_len=cfg.label_len)
    m = train_chunk(state, ds, generator=stream_generator(device, 2), **kwargs)  # warm
    float(m["loss_sum"])
    t0 = time.perf_counter()
    for i in range(chunks):
        m = train_chunk(state, ds, generator=stream_generator(device, 2, i), **kwargs)
        float(m["loss_sum"])  # fetch = the barrier
    ms_step = (time.perf_counter() - t0) / chunks * 1000 / steps
    achieved = flops_step / (ms_step / 1e3)
    return {
        "config": name, "d_model": d_model, "d_ff": d_ff, "seq_len": seq_len, "batch": batch,
        "params": n_params, "dtype": dtype,
        "ms_per_step": round(ms_step, 3),
        "samples_per_s": round(batch / (ms_step / 1e3), 1),
        "gflops_per_step": round(flops_step / 1e9, 2),
        "achieved_tflops": round(achieved / 1e12, 2),
        "mxu_fraction": round(achieved / (PEAK_TFLOPS[dtype] * 1e12), 4),
        "peak_tflops": PEAK_TFLOPS[dtype],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> list:
    """Run the sizes; returns the rows written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    rows = []
    for size in SIZES:
        if args.sizes is not None and size[0] not in args.sizes:
            continue
        row = run_size(*size, dtype=args.dtype, steps=args.steps, chunks=args.chunks,
                       device=device, rng=rng)
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
