"""int8 serving evaluation: accuracy and latency of real quantized inference
(the counterpart of ``experiments/int8_serving.py``).

It restores a ``cli.train_informer`` checkpoint of the flagship (default:
the newest flagship checkpoint under ``weights/``, chosen by the JAX
driver's name filter), builds the int8 table, and measures on the
validation channel the NMSE of the f32 model, of W8A8 serving and of
weight-only serving (``ops/quant/serving.py``), then the latency of each at
the flagship batch. It writes one JSON file (default
``weights/int8_serving.json``) with the JAX driver's keys::

    python -m channelestimationtransformer_torch.cli.int8_serving \\
        --checkpoint weights/tmodel_<name>_50.pt --calibrated --ue-speed-kmh 5

On the card the model takes the bd attention kernels
(``InformerConfig(use_pallas=True)``); ``--device cpu`` runs the plain CPU
path. Batch ``i`` is drawn from the stream ``(11, i)`` (JAX:
``fold_in(key(11), i)``), the dataset from key 7. Latency is the port's own
timing: the median of 10 synchronised timings of 20 forwards each, after 2
warm-ups, divided by 20 (the JAX driver times a 20-step ``lax.scan`` with
``utils/profiling.time_fn``).
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import statistics
import time

import torch

from ..channel.cdl import CDLModel
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, TrainConfig
from ..core.metrics import nmse, nmse_split
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import make_batch
from ..ops.quant.serving import build_int8_table, serving_intercept
from ._study import add_device_arg, flagship_state

MODES = (("f32", None), ("int8", "w8a8"), ("int8_wo", "weight_only"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="int8 serving: accuracy and latency.")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint (.pt of cli.train_informer); default = newest flagship "
                        "weights/tmodel_*21_cal*.pt")
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--ue-speed-kmh", type=float, default=5.0)
    p.add_argument("--calibrated", action="store_true")
    p.add_argument("--val-samples", type=int, default=2048)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--nbits", type=int, default=8)
    p.add_argument("--out", default="weights/int8_serving.json")
    add_device_arg(p)
    return p


def is_flagship(name: str) -> bool:
    """The JAX driver's filter (``experiments/int8_serving.py:66-85``): the
    exact flagship architecture and geometry at SNR 21 on the calibrated
    5 km/h channel; ``_pallas`` runs have the same weights."""
    return ("_sl_90_" in name and "_ll_10_" in name
            and "_dm_128_" in name and "_df_64_" in name
            and "_at_full_" in name and "21_cal_v5" in name
            and "nodistil" not in name)


def newest_flagship_checkpoint(folder: str = "weights"):
    cands = sorted((c for c in glob.glob(os.path.join(folder, "tmodel_*.pt"))
                    if is_flagship(os.path.basename(c))), key=os.path.getmtime)
    return cands[-1] if cands else None


def _serve(model, table, mode):
    """A forward of ``model`` served in ``mode`` (None: f32)."""
    def forward(x_enc, x_dec):
        if mode is None:
            return model(x_enc, x_dec)
        with serving_intercept(model, table, mode=mode):
            return model(x_enc, x_dec)
    return forward


def _latency_ms(forward, x_enc, x_dec, device, n=20, reps=10, warmup=2) -> float:
    """Median over ``reps`` synchronised timings of ``n`` forwards, per forward."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    times = []
    for i in range(warmup + reps):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            forward(x_enc, x_dec)
        sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(times)


@torch.no_grad()
def main(argv=None) -> dict:
    """Run the evaluation; returns the result written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(use_pallas=device.type == "cuda")
    tc = TrainConfig()
    ckpt = args.checkpoint if args.checkpoint is not None else newest_flagship_checkpoint()
    state, epoch = flagship_state(cfg, tc, device, ckpt)
    if ckpt:
        print(f"loaded {ckpt} (epoch {epoch})", flush=True)
    else:
        print("WARNING: no checkpoint found — evaluating random init", flush=True)
    model = state.model.eval()
    table = build_int8_table(model, nbits=args.nbits)
    print(f"int8 layers: {len(table)}", flush=True)

    cdl = (CDLModel.calibrated(ue_speed_kmh=args.ue_speed_kmh) if args.calibrated
           else CDLModel(ue_speed_ms=args.ue_speed_kmh / 3.6))
    ds = make_window_dataset(7, model=cdl, num_samples=args.val_samples, num_slots=100,
                             seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=args.snr,
                             device=device)
    forwards = {name: _serve(model, table, mode) for name, mode in MODES}

    # --- accuracy ---
    stats = {name: [] for name in forwards}
    for i in range(args.batches):
        x_enc, x_dec, target = make_batch(ds, tc.batch_size, cfg.label_len,
                                          generator=stream_generator(device, 11, i))
        for name, fwd in forwards.items():
            pred = fwd(x_enc, x_dec)
            stats[name].append(torch.cat([nmse(pred, target).reshape(1),
                                          nmse_split(pred, target)]))
    res = {"nbits": args.nbits, "layers": len(table), "checkpoint": ckpt}
    for name in forwards:
        s = torch.stack(stats[name]).double().cpu()
        res[f"nmse_{name}"] = float(s[:, 0].mean())
        res[f"split_{name}"] = s[:, 1:].mean(dim=0).tolist()
    res["nmse_delta_db"] = 10 * math.log10(res["nmse_int8"] / res["nmse_f32"])
    res["nmse_delta_db_wo"] = 10 * math.log10(res["nmse_int8_wo"] / res["nmse_f32"])

    # --- latency ---
    x_enc, x_dec, _ = make_batch(ds, tc.batch_size, cfg.label_len,
                                 generator=stream_generator(device, 13))
    for name, fwd in forwards.items():
        res[f"latency_ms_{name}"] = round(_latency_ms(fwd, x_enc, x_dec, device), 4)
    res["latency_speedup"] = round(res["latency_ms_f32"] / res["latency_ms_int8"], 3)
    res["latency_speedup_wo"] = round(res["latency_ms_f32"] / res["latency_ms_int8_wo"], 3)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
