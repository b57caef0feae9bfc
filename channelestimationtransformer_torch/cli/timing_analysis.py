"""Inference latency sweep (the counterpart of ``experiments/timing_analysis.py``).

Reference: ``TimingAnalysis/TrainInformer.py:91-151``: CUDA events around the
forward pass, 20 warmup + 1000 timed reps, mean/std ms, swept over
e_layers/d_layers/n_heads/d_ff/d_model/seq_len/pred_len/label_len
(``:226-264``) -> ``runtime2.pickle``.

Each point is one eval forward of ``InformerConfig(**BASE, <axis>=<value>)``
(random weights of seed 0, zero inputs of ``--batch`` rows; the attention
kernels on the card), timed by ``utils.profiling.time_fn_amortized``:
``--inner`` forwards captured in one CUDA graph and replayed ``--reps``
times, the device time of one forward, as JAX's scan-amortized chain
measures its on-device latency. The JAX driver's sweep matrix, JSON and
pickle, and its check that latency grows with ``seq_len`` and batch
(``_monotonic``; 5% jitter allowed between neighbours)::

    python -m channelestimationtransformer_torch.cli.timing_analysis --out weights/runtime.json
    python -m channelestimationtransformer_torch.cli.timing_analysis --params seq_len batch --reps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle

import torch

from ..core.config import InformerConfig
from ..core.runtime import resolve_device
from ..models.informer import build_informer
from ..utils.profiling import time_fn_amortized
from ._study import add_device_arg

DEFAULT_SWEEP = {
    "e_layers": [(2, 1), (3, 2), (4, 3)],
    "d_layers": [1, 2, 3],
    "n_heads": [4, 8, 16],
    "d_ff": [32, 64, 128, 256],
    "d_model": [64, 128, 256],
    "seq_len": [25, 50, 75, 90],
    "pred_len": [1, 5, 10],
    "label_len": [5, 10, 20],
}
BATCHES = [64, 128, 256]

BASE = dict(seq_len=90, label_len=10, pred_len=5, d_model=128, n_heads=8,
            e_layers=(4, 3), d_layers=3, d_ff=64)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Eval-forward latency over the reference's sweep.")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=10,
                   help="outer timing reps (each replays --inner captured forwards)")
    p.add_argument("--inner", type=int, default=20,
                   help="forwards captured in one CUDA graph")
    p.add_argument("--params", nargs="+", default=list(DEFAULT_SWEEP) + ["batch"],
                   help="which sweep axes to run")
    p.add_argument("--out", default="weights/runtime.json")
    add_device_arg(p)
    return p


def sweep_configs(params, batch: int):
    """``(key, config, batch)`` of every sweep point of the axes ``params``."""
    for pname in params:
        for value in BATCHES if pname == "batch" else DEFAULT_SWEEP[pname]:
            overrides = dict(BASE)
            if pname != "batch":
                overrides[pname] = value
            yield (f"{pname}={value}", InformerConfig(**overrides),
                   value if pname == "batch" else batch)


def measure(cfg: InformerConfig, batch: int, reps: int, inner: int, device):
    """Mean/std device ms of one eval forward of ``cfg`` at ``batch``."""
    cfg = dataclasses.replace(cfg, use_pallas=device.type == "cuda")
    model = build_informer(cfg, device=device, seed=0)
    x_enc = torch.zeros(batch, cfg.seq_len, cfg.enc_in, device=device)
    x_dec = torch.zeros(batch, cfg.dec_len, cfg.dec_in, device=device)

    @torch.no_grad()
    def fwd(a, b):
        return model(a, b)

    return time_fn_amortized(fwd, x_enc, x_dec, inner=inner, warmup=3, reps=reps)


def monotonic(results: dict) -> bool:
    """Latency must grow with work along ``seq_len`` and batch (5% jitter
    between neighbours): a violation means the measurement is broken, not
    that a bigger model is faster."""
    checks = {"seq_len": DEFAULT_SWEEP["seq_len"], "batch": BATCHES}
    sane = True
    for axis, vals in checks.items():
        series = [results[f"{axis}={v}"]["mean_ms"] for v in vals if f"{axis}={v}" in results]
        for a, b in zip(series, series[1:]):
            if b < a * 0.95:
                sane = False
                print(f"MONOTONICITY VIOLATION on {axis}: {series}")
    return sane


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for key, cfg, batch in sweep_configs(args.params, args.batch):
        mean_ms, std_ms = measure(cfg, batch, args.reps, args.inner, device)
        results[key] = {"mean_ms": mean_ms, "std_ms": std_ms,
                        "samples_per_s": batch / (mean_ms / 1000)}
        print(f"{key}: {mean_ms:.3f} +- {std_ms:.3f} ms "
              f"({results[key]['samples_per_s']:.0f} samples/s)", flush=True)
    sane = monotonic(results)
    results["_monotonic"] = sane

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    with open(args.out.replace(".json", ".pickle"), "wb") as f:
        pickle.dump(results, f)
    print(json.dumps({"sweep": "timing", "entries": len(results), "monotonic": sane}))
    return results


if __name__ == "__main__":
    main()
