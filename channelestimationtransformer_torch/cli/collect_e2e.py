"""Consolidate the end-to-end link-simulation branches into one artifact
(the counterpart of ``experiments/collect_e2e.py``).

The reference's Sionna model switches perfect-CSI/LS estimation and
frequency/time-domain channels inside one Keras model
(``MimoSimulation/KerasFullSimulation.py:200-317``); here they are separate
``cli.end_to_end_sim`` runs (uncoded, conv-coded, LDPC-coded, LS CSI, time
domain). This collector starts from the JAX package's committed artifacts
as JAX's does (``experiments/artifacts/e2e_results.json`` and the run logs
``logs/e2e_*.log``, re-parsed), then merges fresh run outputs by branch::

    python -m channelestimationtransformer_torch.cli.collect_e2e \\
        --extra uncoded=weights/e2e_results.json coded_conv=weights/e2e_coded_conv.json

Its default ``--out`` is ``weights/e2e_branches.json``: the JAX artifact
``experiments/artifacts/e2e_branches.json`` is never written. It computes on
no device and takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re

ROOT = str(pathlib.Path(__file__).resolve().parents[2])

_LINE = re.compile(
    r"^(perfect|outdated|predicted): SE ([\d.]+) b/s/Hz, (coded )?BER "
    r"\[([^\]]+)\](?:, BLER \[([^\]]+)\])?"
)

LOGS = (("coded_conv", "logs/e2e_conv.log"), ("ls_csi", "logs/e2e_ls.log"),
        ("time_domain", "logs/e2e_time.log"), ("coded_ldpc", "logs/e2e_ldpc.log"))


def parse_log(path: str) -> dict | None:
    """Recover {ber, bler, se} per CSI source from an e2e run log."""
    out: dict = {"ber": {}, "se": {}, "recovered_from": os.path.relpath(path, ROOT)}
    found = False
    with open(path, errors="replace") as f:
        for raw in f:
            # conv logs contain tqdm \r frames; scan every fragment
            for line in raw.replace("\r", "\n").splitlines():
                m = _LINE.match(line.strip())
                if not m:
                    continue
                found = True
                name, se, coded, bers, blers = m.groups()
                out["ber"][name] = [float(x) for x in bers.split(",")]
                out["se"][name] = float(se)
                out["coded"] = bool(coded)
                if blers:
                    out.setdefault("bler", {})[name] = [float(x) for x in blers.split(",")]
    return out if found else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Merge the e2e branches into one artifact.")
    p.add_argument("--extra", nargs="*", default=[],
                   help="branch=path.json pairs from fresh runs")
    p.add_argument("--out", default="weights/e2e_branches.json")
    return p


def main(argv=None) -> dict:
    """Merge and write ``--out``; returns the branches."""
    args = build_parser().parse_args(argv)
    branches: dict = {}

    # Headline uncoded artifact (committed round 2).
    headline = os.path.join(ROOT, "experiments", "artifacts", "e2e_results.json")
    if os.path.exists(headline):
        with open(headline) as f:
            branches["uncoded"] = json.load(f)

    for branch, log in LOGS:
        path = os.path.join(ROOT, log)
        if branch in branches or not os.path.exists(path):
            continue
        rec = parse_log(path)
        if rec:
            branches[branch] = rec

    for pair in args.extra:
        branch, _, path = pair.partition("=")
        with open(path) as f:
            branches[branch] = json.load(f)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(branches, f, indent=1)
    print(json.dumps({"artifact": os.path.relpath(os.path.abspath(args.out), ROOT),
                      "branches": sorted(branches)}), flush=True)
    return branches


if __name__ == "__main__":
    main()
