"""Streaming-predictor experiment: train offline, evaluate blockwise online
(the counterpart of ``experiments/train_streaming.py``).

Reference: ``StreamingTransformer(WIP)/``, a stateful blockwise model that
was never finished. Here the streaming path (``models/streaming.py``) runs
a ``cli.train_informer`` checkpoint of the flagship:

1. restore the Informer;
2. stream validation trajectories block by block;
3. report per-block prediction NMSE, and its mean once the window is full
   (``warm_window_nmse``), which is the offline forward's quality.

It writes ``--out`` (default ``weights/streaming_results.json``) with the
JAX driver's keys::

    python -m channelestimationtransformer_torch.cli.train_streaming \\
        --checkpoint weights/tmodel_<name>_50.pt --calibrated --ue-speed-kmh 5

The trajectories are windows of ``seq_len=95, pred_len=block`` slots (JAX
``:60-63``) from the dataset of key 7, drawn from the stream ``(8,)``.
``--device`` goes beyond the JAX driver; the model runs the bd attention
kernels on the card (``InformerConfig(use_pallas=True)``), as
``cli.int8_serving``'s does.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..channel.cdl import add_channel_args
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import sample_windows
from ..models.streaming import streaming_rollout
from ._study import add_device_arg, datasets, flagship_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Blockwise streaming prediction.")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--block", type=int, default=5)
    p.add_argument("--batch", type=int, default=128)
    add_channel_args(p)
    p.add_argument("--out", default="weights/streaming_results.json")
    add_device_arg(p)
    return p


@torch.no_grad()
def main(argv=None) -> dict:
    """Run the experiment; returns the result written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(use_pallas=device.type == "cuda")
    state, _ = flagship_state(cfg, TrainConfig(), device, args.checkpoint)
    model = state.model.eval()
    window_cfg = InformerConfig(seq_len=95, pred_len=args.block)
    (ds,) = datasets(args, window_cfg, device, (7, 1024))
    clean, noisy, _, _ = sample_windows(ds, args.batch, generator=stream_generator(device, 8))
    # Stream the noisy trajectory; each ingested block predicts the next block.
    preds = streaming_rollout(model, cfg, noisy, block=args.block)  # [n_blocks, B, pred, F]

    n_blocks = preds.shape[0]
    warm = cfg.seq_len // args.block  # blocks until the window is full
    errs = []
    for i in range(n_blocks - 1):
        target = clean[:, (i + 1) * args.block:(i + 2) * args.block]
        if target.shape[1] < args.block:
            break
        errs.append(torch.sum(torch.square(preds[i] - target)) / torch.sum(torch.square(target)))
    per_block = torch.stack(errs).double().cpu().tolist() if errs else []
    warm_nmse = (sum(per_block[warm - 1:]) / len(per_block[warm - 1:])
                 if len(per_block) >= warm else None)
    result = {
        "block": args.block,
        "per_block_nmse": per_block,
        "warm_window_nmse": warm_nmse,
        "warm_window_nmse_db": float(10 * math.log10(warm_nmse)) if warm_nmse else None,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
