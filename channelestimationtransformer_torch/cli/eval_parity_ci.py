"""Bootstrap confidence intervals for the parity rows (the counterpart of
``experiments/eval_parity_ci.py``).

The parity table's point estimates come from each training run's final
validation (8 batches = 2,048 windows). This driver re-evaluates every row
of ``--parity`` (``cli.collect_results``'s ``parity.json``) whose
checkpoint (``cli.train_informer``'s ``tmodel_<run>_<epoch>.pt``, the
newest) is in ``--weights``, on ``--batches`` (default 64) validation
batches of 256: it regenerates the run's own validation set with the
port's generator (the cluster's channel calibration, the stream
``cli.train_informer`` keys it by, ``(100, 1)`` at seed 0) and evaluates
through ``eval_chunk``, one batch at a time from the keyed streams
``(4242, i)``; on the card the model takes the attention kernels. It
attaches a bootstrap CI to each row's NMSE and to its dB delta against the
reference::

    python -m channelestimationtransformer_torch.cli.eval_parity_ci --parity weights/parity.json \\
        --weights weights --out weights/parity_ci.json

Metric per batch: mean of the 5-horizon ``NMSELossSplit`` (the reference's
logged "valid loss"). CI: percentile bootstrap (10k resamples) over the
per-batch values. ``cli.collect_results --ci`` merges the CI column.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re

import numpy as np
import torch

from ..channel.cdl import CDLModel
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..models.informer import build_informer
from ..train.checkpoint import latest_checkpoint, load_checkpoint
from ..train.trainer import create_train_state, eval_chunk
from ._study import add_device_arg
from .collect_results import CLUSTERS, parse_name

BATCH = 256


def bootstrap_ci(vals: np.ndarray, n_boot: int = 10_000, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(vals), size=(n_boot, len(vals)))
    means = vals[idx].mean(axis=1)
    return float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5))


def cdl_for_cluster(spec: dict) -> CDLModel:
    if spec["cal"]:
        return CDLModel.calibrated(ue_speed_kmh=spec["speed"])
    return CDLModel(sampling_frequency=120e3 / spec["ss"], ue_speed_ms=30 / 3.6)


def cfg_from_fields(f: dict) -> InformerConfig:
    return InformerConfig(
        seq_len=f["seq_len"], label_len=f["label_len"],
        d_model=f["d_model"], d_ff=f["d_ff"], attn=f["attn"],
        distil=(f["distil"] == "on"),
    )


def find_checkpoint(weights_dir: str, run_name: str):
    """The newest ``tmodel_<run_name>_<epoch>.pt`` and its epoch, or (None, -1)."""
    path = latest_checkpoint(weights_dir, f"tmodel_{run_name}_")
    if path is None:
        return None, -1
    return path, int(re.search(r"_(\d+)\.pt$", path).group(1))


def eval_batches(model, ds, *, num_batches: int, label_len: int) -> np.ndarray:
    """Per-batch split means: ``eval_chunk`` of one batch from each keyed
    stream ``(4242, i)``; one fetch from the device."""
    vals = [eval_chunk(model, ds, num_batches=1, batch_size=BATCH, label_len=label_len,
                       generator=stream_generator(ds.h.device, 4242, i))["split"].mean()
            for i in range(num_batches)]
    return torch.stack(vals).double().cpu().numpy()


def evaluate_row(run_name: str, axis: str, snr: float, *, weights: str, batches: int,
                 val_samples: int, device, use_pallas: bool, ds_cache: dict) -> dict:
    """One parity row's re-evaluation: its checkpoint epoch, the number and
    mean of the per-batch values, their bootstrap CI and standard
    deviation; or an ``error``."""
    fields = parse_name(run_name)
    if not fields:
        return {"error": "unparseable run name"}
    ckpt, ep = find_checkpoint(weights, run_name)
    if not ckpt:
        return {"error": "no checkpoint on disk"}
    spec = CLUSTERS[axis]
    cfg = dataclasses.replace(cfg_from_fields(fields), use_pallas=use_pallas)
    tc = TrainConfig()
    state = create_train_state(build_informer(cfg, device=device, seed=0), tc)
    state, _, _ = load_checkpoint(ckpt, state)

    ds_key = (json.dumps(spec, sort_keys=True), cfg.seq_len, cfg.pred_len, snr)
    if ds_key not in ds_cache:
        ds_cache[ds_key] = make_window_dataset(
            (100, 1), model=cdl_for_cluster(spec), num_samples=val_samples, num_slots=100,
            seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=snr, device=device)
    vals = eval_batches(state.model, ds_cache[ds_key], num_batches=batches,
                        label_len=cfg.label_len)
    lo, hi = bootstrap_ci(vals)
    return {"checkpoint_epoch": ep, "n": len(vals),
            "mean": float(vals.mean()),
            "ci95": [lo, hi],
            "per_batch_std": float(vals.std(ddof=1))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Bootstrap CIs of the parity rows.")
    ap.add_argument("--parity", default="weights/parity.json")
    ap.add_argument("--weights", default="weights")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--val-samples", type=int, default=2048)
    ap.add_argument("--out", default="weights/parity_ci.json")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    with open(args.parity) as f:
        parity = json.load(f)
    ds_cache = {}
    out = {"batches": args.batches,
           "windows": args.batches * BATCH,
           "method": "percentile bootstrap, 10k resamples over per-batch "
                     "split-mean values; val set regenerated at the run's "
                     "cluster calibration (train_informer seed protocol)",
           "rows": {}}
    for axis, block in parity.get("sweeps", {}).items():
        for val, row in block.get("rows", {}).items():
            run = row.get("run")
            ref = row.get("ref")
            if not run:
                continue
            snr = float(val) if axis == "snr" else 21.0
            res = evaluate_row(run, axis, snr, weights=args.weights, batches=args.batches,
                               val_samples=args.val_samples, device=device,
                               use_pallas=device.type == "cuda", ds_cache=ds_cache)
            if ref and "mean" in res:
                res["ref"] = ref
                res["delta_db"] = float(10 * np.log10(res["mean"] / ref))
                res["delta_db_ci95"] = [
                    float(10 * np.log10(res["ci95"][0] / ref)),
                    float(10 * np.log10(res["ci95"][1] / ref)),
                ]
                res["excludes_zero"] = res["delta_db_ci95"][1] < 0.0
            out["rows"][f"{axis}:{val}"] = res
            print(json.dumps({f"{axis}:{val}": res}), flush=True)

    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    n_ok = sum(1 for r in out["rows"].values() if "mean" in r)
    print(f"wrote {args.out}: {n_ok}/{len(out['rows'])} rows evaluated")
    return out


if __name__ == "__main__":
    main()
