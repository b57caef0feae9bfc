"""Is the port's channel the JAX package's in distribution? The key-to-key
spread of the two statistics that JAX's artifacts record on one key each:

- the AR(30) oracle's NMSE bound (``cli/ar_oracle.py``, 14-symbol slots,
  30 km/h, 256 windows) over ``--oracle-keys`` dataset keys, against
  ``experiments/artifacts/ar_oracle.json``;
- the UE-speed fit of ``cli/calibrate_channel.py`` (the Wiener bound
  against the reference's SNR table) over ``--calibration-keys`` generator
  keys, on ``--speeds`` (the grid of ``experiments/artifacts/calibration.json``:
  6.0 km/h fitted, rms 0.63 dB).

For each statistic the JSON holds every key's value, the spread (min, max,
mean, standard deviation) and whether JAX's value lies inside [min, max]::

    python -m channelestimationtransformer_torch.cli.channel_spread \\
        --out weights/channel_spread.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.runtime import resolve_device
from . import ar_oracle, calibrate_channel
from ._study import add_device_arg

ARTIFACTS = "experiments/artifacts"
AR_ARGS = ["--slot-symbols", "14", "--order", "30", "--snr", "12", "14", "16", "18", "20",
           "21"]
CALIBRATION_N = 2048  # samples of 95 slots a fit, as calibration.json's


def _spread(values, ref) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {"min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0, "jax": ref,
            "jax_inside": bool(v.min() <= ref <= v.max())}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Key-to-key spread of the channel statistics.")
    p.add_argument("--oracle-keys", type=int, nargs="+",
                   default=[1234, 1, 2, 3, 4, 5, 6, 7])
    p.add_argument("--calibration-keys", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--speeds", type=str, default="4,5,6,30")
    p.add_argument("--out", default="weights/channel_spread.json")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    with open(os.path.join(ARTIFACTS, "ar_oracle.json")) as f:
        jax_oracle = {k: r["nmse_db"] for k, r in json.load(f)["snr"].items()}
    with open(os.path.join(ARTIFACTS, "calibration.json")) as f:
        jax_cal = json.load(f)

    ar_args = ar_oracle.build_parser().parse_args(AR_ARGS)
    per_key = {}
    for key in args.oracle_keys:
        rows = ar_oracle.oracle_rows(ar_args, device, dataset_key=key, log=lambda line: None)
        per_key[key] = {snr: r["nmse_db"] for snr, r in rows.items()}
        print(json.dumps({"oracle_key": key, "nmse_db": {s: round(v, 3) for s, v in
                                                         per_key[key].items()}}), flush=True)
    oracle = {"keys": args.oracle_keys, "per_key": per_key,
              "spread_db": {snr: _spread([per_key[k][snr] for k in args.oracle_keys], ref)
                            for snr, ref in jax_oracle.items()}}

    speeds = [float(s) for s in args.speeds.split(",")]
    fits = {}
    for key in args.calibration_keys:
        rows, best, cost = calibrate_channel.fit_speed(speeds, CALIBRATION_N, device=device,
                                                       seed=key, log=lambda msg: None)
        fits[key] = {"fitted_speed_kmh": best, "fitted_rms_delta_db": round(cost, 2),
                     "rms_delta_db": {v: r["rms_delta_db"] for v, r in rows.items()}}
        print(json.dumps({"calibration_key": key, **fits[key]}), flush=True)
    calibration = {
        "keys": args.calibration_keys, "speeds": speeds, "per_key": fits,
        "fitted_speed_kmh": _spread([fits[k]["fitted_speed_kmh"] for k in fits],
                                    jax_cal["fitted_speed_kmh"]),
        "rms_delta_db": {v: _spread([fits[k]["rms_delta_db"][v] for k in fits],
                                    jax_cal["speed_grid"][v]["rms_delta_db"])
                         for v in jax_cal["speed_grid"] if v in fits[args.calibration_keys[0]]
                         ["rms_delta_db"]},
    }
    out = {"ar_oracle": oracle, "calibration": calibration}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"oracle_jax_inside": {s: r["jax_inside"]
                                            for s, r in oracle["spread_db"].items()},
                      "fitted_speed_jax_inside": calibration["fitted_speed_kmh"]["jax_inside"],
                      "rms_jax_inside": {v: r["jax_inside"]
                                         for v, r in calibration["rms_delta_db"].items()}}))
    return out


if __name__ == "__main__":
    main()
