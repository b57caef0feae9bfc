"""int8 serving latency A/B at the scale-demo sizes (the counterpart of
``experiments/int8_scale_ab.py``).

``cli.int8_serving`` measures accuracy and latency at the flagship, where a
forward is host-bound. This driver times the same serving paths
(``ops/quant/serving.py``) at the widths of ``cli.scale_demo`` (d_model
256-1024). Latency does not depend on the weights' values, so each model has
random weights from the port's seeded builder (seed 0).

Variants a size: f32, bf16, W8A8 int8 serving on the f32 base, and
weight-only int8 (int8 weights, bf16 products summed in f32) on the bf16
base, as JAX's (``:69-77``). On the card the model takes the attention
kernels where they take the shape. Timing is the port's own, as
``cli.int8_serving``'s: the median of ``--reps`` synchronised timings of
``--scan`` forwards after two warm-ups, divided by ``--scan``. Writes
``--out`` (default ``weights/int8_scale_ab.json``) with JAX's keys, the
card's name beside them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.config import InformerConfig
from ..core.runtime import resolve_device
from ..models.informer import build_informer
from ..ops.quant.serving import build_int8_table
from ._study import add_device_arg
from .int8_serving import _latency_ms, _serve

SIZES = [
    # (name, d_model, d_ff, seq_len, batch): scale_demo.py geometry
    ("reference", 128, 64, 90, 256),
    ("medium", 256, 1024, 128, 256),
    ("large", 512, 2048, 256, 128),
    ("xl", 1024, 4096, 256, 64),
]
# variant -> (base dtype, serving mode); W8A8 on the f32 base, weight-only on bf16
VARIANTS = {"float32": ("float32", None), "bfloat16": ("bfloat16", None),
            "int8": ("float32", "w8a8"), "int8_wo": ("bfloat16", "weight_only")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="int8 serving latency at the scale-demo sizes.")
    p.add_argument("--scan", type=int, default=20, help="forwards timed together")
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--sizes", nargs="*", default=None)
    p.add_argument("--out", default="weights/int8_scale_ab.json")
    add_device_arg(p)
    return p


@torch.no_grad()
def run_size(name, d_model, d_ff, seq_len, batch, *, scan, reps, device, rng) -> dict:
    row = {"config": name, "d_model": d_model, "d_ff": d_ff, "seq_len": seq_len,
           "batch": batch}
    for variant, (dtype, mode) in VARIANTS.items():
        cfg = InformerConfig(d_model=d_model, d_ff=d_ff, seq_len=seq_len, dtype=dtype,
                             use_pallas=device.type == "cuda")
        model = build_informer(cfg, device=device, seed=0)
        x_enc = torch.as_tensor(rng.normal(size=(batch, cfg.seq_len, cfg.enc_in)),
                                dtype=torch.float32, device=device)
        x_dec = torch.as_tensor(rng.normal(size=(batch, cfg.dec_len, cfg.dec_in)),
                                dtype=torch.float32, device=device)
        table = build_int8_table(model) if mode else None
        ms = _latency_ms(_serve(model, table, mode), x_enc, x_dec, device, n=scan, reps=reps)
        row[f"ms_{variant}"] = round(ms, 4)
        row[f"samples_per_s_{variant}"] = round(batch / (ms / 1e3), 1)
    for variant in ("int8", "int8_wo"):
        for base in ("f32", "bf16"):
            ref = row["ms_float32" if base == "f32" else "ms_bfloat16"]
            row[f"{variant}_speedup_vs_{base}"] = round(ref / row[f"ms_{variant}"], 3)
    row["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return row


def main(argv=None) -> list:
    """Run the sizes; returns the rows written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    rows = []
    for size in SIZES:
        if args.sizes is not None and size[0] not in args.sizes:
            continue
        row = run_size(*size, scan=args.scan, reps=args.reps, device=device, rng=rng)
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
