"""The readings that a cell's limits of the comparison are set from, on the
card, at the cell's own sizes, in one process:

- the lower readings: the program's numbers over a dozen seeds or more
  (each a run of the cell with a short window);
- the control: the reference put in the program's place, in the precision
  just below the configuration's (float32: TF32 on; bfloat16: float8
  e4m3 operands of every product), against the float32 reference;
- the faults of ``faults.py`` that the cell can have, planted in the
  program.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 --fault-seeds 201 202 203 --seconds 2

Prints one JSON line a reading, then a summary: for each number the largest
lower reading, the smallest upper reading (control or fault) and a limit
between them, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

CONTROL = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers: the reference in the precision below the
    configuration's, against the float32 reference, at the cell's sizes."""
    return cell.loop.control(cell, seed, device,
                             cell.ref.Precision(CONTROL[cell.model["dtype"]]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="calibration")
    args = p.parse_args(argv)
    import torch

    from . import faults
    from .manifest import Manifest
    from .workload import Cell, run

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    manifest = Manifest()
    cell = Cell(manifest, args.workload)
    rows = []

    def record(kind, seed, numbers, extra=None):
        row = {"reading": kind, "seed": seed, "numbers": numbers, **(extra or {})}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def quiet(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in args.seeds:
        r = run(manifest, args.workload, seed=seed, seconds=args.seconds, trace=False,
                device="cuda:0", t_start=time.perf_counter(), log=quiet)
        record("program", seed, {k: c["value"] for k, c in r["checks"].items()},
               {"metrics": r["metrics"]})
    for seed in args.control_seeds:
        record("control", seed, control_numbers(cell, seed, torch.device("cuda:0")))
    for name in faults.FAULTS[cell.kind] if args.fault_seeds else ():
        for seed in args.fault_seeds:
            with faults.plant(name, cell.kind):
                r = run(manifest, args.workload, seed=seed, seconds=args.seconds,
                        trace=False, device="cuda:0", t_start=time.perf_counter(), log=quiet)
            record(f"fault:{name}", seed, {k: c["value"] for k, c in r["checks"].items()})
    summary = {}
    for number in cell.limits:
        lower = max(r["numbers"][number] for r in rows if r["reading"] == "program")
        uppers = {r["reading"]: min(x["numbers"][number] for x in rows
                                    if x["reading"] == r["reading"])
                  for r in rows if r["reading"] != "program"}
        catching = {k: v for k, v in uppers.items() if v >= 3 * lower}
        upper = min(catching.values()) if catching else None
        limit = (lower ** 0.4 * upper ** 0.6 if upper is not None and lower > 0
                 and math.isfinite(upper) else None)
        summary[number] = {"lower": lower, "uppers": uppers, "upper": upper,
                           "suggested_limit": limit}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}.json").write_text(json.dumps({"rows": rows, "summary": summary},
                                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
