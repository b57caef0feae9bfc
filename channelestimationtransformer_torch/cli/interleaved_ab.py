"""Training-step variants timed in turns (the counterpart of
``experiments/interleaved_ab.py``, flag for flag).

``cli/perf_study.py`` times each variant once, minutes apart; a card
shared with other work drifts on that timescale, which can pass for a
variant effect. This driver builds and warms every variant first, then
times one chunk of each in turn, round after round, and reports each
variant's median: per-step differences survive, drift cancels. Each chunk
is ``train_chunk`` of the flagship at batch 256 on the same seeded normal
dataset, timed by the host clock to its loss's fetch. ``+rbg`` (JAX's TPU
key implementation) has no torch counterpart: such a variant runs as its
base variant, and its row says so (``runs_as``)::

    python -m channelestimationtransformer_torch.cli.interleaved_ab \\
        --out weights/interleaved_ab.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

from ..core.runtime import resolve_device
from . import perf_study
from ._study import add_device_arg

VARIANTS = perf_study.VARIANTS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Time training-step variants in turns.")
    p.add_argument("--steps", type=int, default=10, help="steps per chunk")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--out", default="weights/interleaved_ab.json")
    add_device_arg(p)
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    runners = {}
    for variant in args.variants:
        cfg, state, ds, base = perf_study.train_setup(variant, device)
        for i in range(2):  # build + warm
            perf_study.run_chunk(cfg, state, ds, 2, i, steps=args.steps)
        runners[variant] = {"run": (cfg, state, ds), "base": base, "times": []}
        print(f"compiled {variant}", flush=True)

    for r in range(args.rounds):
        for variant in args.variants:
            ru = runners[variant]
            t0 = time.perf_counter()
            perf_study.run_chunk(*ru["run"], 2, 100 + r, steps=args.steps)
            ru["times"].append((time.perf_counter() - t0) * 1000)
        print(f"round {r}: " + " ".join(
            f"{v}={runners[v]['times'][-1]:.1f}ms" for v in args.variants), flush=True)

    out = []
    for variant in args.variants:
        ts = runners[variant]["times"]
        med = statistics.median(ts)
        row = {
            "variant": variant, "steps_per_chunk": args.steps,
            "median_ms_per_batch": round(med / args.steps, 4),
            "all_chunk_ms": [round(t, 2) for t in ts],
            "samples_per_s": round(perf_study.BATCH * args.steps / (med / 1000), 1),
        }
        if runners[variant]["base"] != variant:
            row["runs_as"] = runners[variant]["base"]
        out.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "all_chunk_ms"}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
