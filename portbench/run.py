"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cells, and the
cell's configuration, traffic, limits and metric readers are found by name
under ``portbench/``. The program under test is the PyTorch port
``channelestimationtransformer_torch``. Without a CUDA card, or with fewer
cards than the cell asks for, the run exits 2 and prints no result; it never
runs on the CPU. The last line on standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; the numbers compared and their limits last,
under ``checks``); the last lines on standard error are the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """``time.perf_counter()``'s reading when this process started."""
    now = time.perf_counter()
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
CHECKOUT = Path(__file__).resolve().parents[1]
# Kernel and build caches at fixed paths inside the checkout, so that only a
# checkout's first run builds (the port's nvcc builds go to its own
# ``channelestimationtransformer_torch/build/``, also inside the checkout).
CACHE = CHECKOUT / ".portbench_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: a traced slice and the per-layer metrics, no window")
    return p


def _card_line() -> str:
    import subprocess

    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    import torch

    from .manifest import Manifest
    from .workload import forbidden_modules, run

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
        return 2
    manifest = Manifest()
    chips = manifest.cell(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards; {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run(manifest, args.workload, seed=args.seed, seconds=args.seconds,
                 trace=bool(args.trace), device="cuda:0", t_start=T_START,
                 log=lambda msg: print(msg, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    card = _card_line()
    print(f"card: {card}", file=sys.stderr)
    checks = result.pop("checks")
    result.update(card=card, checks=checks)  # the numbers compared come last
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
