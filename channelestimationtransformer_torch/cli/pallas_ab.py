"""Summarize the bd-kernel training A/B: the ``--use-pallas`` run against
the plain-path baseline at the identical recipe, the SNR-21 calibrated row
(the counterpart of ``experiments/pallas_ab.py``, line for line).

Reads ``<dir>/result_*_pallas_*.json`` (the last match in sorted order whose
name is a full-attention SNR-21 calibrated run) and the baseline row of
``<dir>/parity.json``, else of ``experiments/artifacts/parity.json``;
writes ``<dir>/pallas_ab.json``. Host-side JSON only: no device::

    python -m channelestimationtransformer_torch.cli.pallas_ab weights
"""

from __future__ import annotations

import glob
import json
import math
import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "weights"
    pal = None
    for p in sorted(glob.glob(os.path.join(out_dir, "result_*_pallas_*.json"))):
        with open(p) as f:
            r = json.load(f)
        if "_at_full_" in r["name"] and "_21_cal" in r["name"]:
            pal = r
    if pal is None:
        print("no pallas A/B run found")
        return None
    base = None
    ppath = os.path.join(out_dir, "parity.json")
    if not os.path.exists(ppath):
        ppath = "experiments/artifacts/parity.json"
    with open(ppath) as f:
        parity = json.load(f)
    row = parity["sweeps"]["snr"]["rows"].get("21")
    if row:
        base = row
    sm_pal = sum(pal["final_val_split"]) / len(pal["final_val_split"])
    res = {
        "pallas_run": pal["name"],
        "pallas_split_mean": sm_pal,
        "pallas_nmse": pal["final_val_nmse"],
        "baseline_split_mean": base["split_mean"] if base else None,
        "baseline_run": base["run"] if base else None,
        "delta_db": (
            10 * math.log10(sm_pal / base["split_mean"]) if base else None
        ),
        "note": "identical recipe (50 ep, lr 1e-3, calibrated 5 km/h, "
                "SNR 21); delta is run-to-run noise if the kernel is "
                "training-equivalent",
    }
    with open(os.path.join(out_dir, "pallas_ab.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
