"""The ProbSparse layout crossover on this card (the counterpart of
``experiments/prob_crossover.py``).

``models/attention.py:prob_sparse_attention`` takes its scores from one
dense ``[B, H, L_Q, L_K]`` product up to ``DENSE_SCORES_MAX_LK`` keys and
gathers keys per query beyond it. The constant, 2048, is where the JAX
package measured the gather layout to win on its TPU. This driver times
forward + backward (the gradient in q of the output's sum) of both layouts
at ``SHAPES`` (batch scaled down with L to hold the dense scores' footprint
near constant), median of 3 runs of 10 calls by the host clock to a
synchronise, and records where the gather layout wins here. JAX's driver
takes no flags and writes into the repo's artifacts; here ``--out`` names
the file and ``--shapes`` (``L:batch,...``) a subset::

    python -m channelestimationtransformer_torch.cli.prob_crossover \\
        --out weights/prob_crossover.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.runtime import resolve_device
from ..models.attention import draw_index_sample, prob_sparse_attention
from ._study import add_device_arg
from .prob_profile import grad_of, timeit

# (l, batch): keep b*l ~ 24k so dense scores stay ~b*h*l^2*4B <= ~1.5 GB.
SHAPES = [(128, 192), (256, 96), (384, 64), (512, 48), (768, 32),
          (1024, 24), (1536, 16), (2048, 12)]
H, E = 8, 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Time ProbSparse's two score layouts.")
    p.add_argument("--shapes", type=str, default=None,
                   help="L:batch pairs, comma-separated (default: all of SHAPES)")
    p.add_argument("--out", default="weights/prob_crossover.json")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    shapes = (SHAPES if args.shapes is None else
              [tuple(int(x) for x in s.split(":")) for s in args.shapes.split(",")])
    rng = np.random.default_rng(0)
    rows = []
    for l, b in shapes:
        row = {"l": l, "batch": b}
        q, k, v = (torch.as_tensor(rng.normal(size=(b, l, H, E)), dtype=torch.float32,
                                   device=device) for _ in range(3))
        index_sample = draw_index_sample(l, l, 5, torch.Generator(device=device).manual_seed(7),
                                         device)
        for name, dense in (("dense_select", True), ("key_gather", False)):
            fn = grad_of(lambda q, k, v, d=dense: prob_sparse_attention(
                q, k, v, mask_flag=False, factor=5, index_sample=index_sample,
                dense_layout=d)[0])
            try:
                row[f"ms_{name}"] = round(timeit(fn, q, k, v, device=device), 3)
            except torch.cuda.OutOfMemoryError as exc:
                row[f"ms_{name}"] = None
                row[f"err_{name}"] = str(exc)[:150]
        if row.get("ms_dense_select") and row.get("ms_key_gather"):
            row["dense_wins"] = row["ms_dense_select"] < row["ms_key_gather"]
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {"shapes_note": "fwd+bwd (grad in q) per call, median of 3x10 reps, heads=8 dim=16, "
                          "batch scaled down with l",
           "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
