"""Structured pruning (the counterpart of ``experiments/prune.py``).

Reference: ``Pruning(WIP)/prune.py:132-314``: neural_compressor's
``snip_momentum`` pruning with a 4x1 block pattern to 90% sparsity, on a
gradual schedule woven into the FP32 training loop. Each epoch takes one
sparsity level on the cubic ramp over the first 60% of the steps (rounded
to 4 places); every optimizer step is followed by ``apply_pruning`` at it,
written into the same ``Parameter`` objects (``assign_``), so Adam keeps
its moments. Per epoch 4 validation batches and ``measured_sparsity``; at
the end ``prune_results.json`` and the checkpoint ``pruned_<epochs>.pt``::

    python -m channelestimationtransformer_torch.cli.prune --use-pallas \\
        --checkpoint weights/tmodel_<name>_50.pt --target-sparsity 0.9 --epochs 50 \\
        --calibrated --ue-speed-kmh 5 --train-samples 16384

The optimizer starts afresh after the preload, at lr 1e-4 on a schedule of
``--epochs`` x ``--steps-per-epoch``. Epoch ``e`` trains from the stream
``(9, e)`` and validates batch ``i`` from ``(9, 2**20, e, i)``.
``--device`` and ``--use-pallas`` go beyond the JAX driver.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..channel.cdl import add_channel_args
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..ops.prune import apply_pruning, cubic_sparsity_schedule, measured_sparsity
from ..ops.quant import assign_
from ..train.checkpoint import save_checkpoint
from ..train.trainer import train_step
from ._study import add_port_args, datasets, flagship_state, validate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Structured 4x1 block pruning during training.")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--target-sparsity", type=float, default=0.9)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps-per-epoch", type=int, default=226)
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--train-samples", type=int, default=8192)
    add_channel_args(p)
    p.add_argument("--out", default="weights")
    add_port_args(p)
    return p


def epoch_sparsity(epoch: int, args) -> float:
    """One sparsity level per epoch along the cubic ramp over the first 60%
    of the steps, rounded to 4 places (``experiments/prune.py:101-107``)."""
    total_steps = args.epochs * args.steps_per_epoch
    return round(cubic_sparsity_schedule(
        epoch * args.steps_per_epoch, target=args.target_sparsity, start_step=0,
        end_step=int(total_steps * 0.6)), 4)


def main(argv=None) -> list:
    """Run the ramp; returns the per-epoch results."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(use_pallas=args.use_pallas)
    tc = TrainConfig(lr=1e-4, num_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    state, _ = flagship_state(cfg, tc, device, args.checkpoint)
    if args.checkpoint:
        print(f"Preloaded {args.checkpoint}", flush=True)
    train_ds, val_ds = datasets(args, cfg, device, (100, args.train_samples), (101, 2048))
    model = state.model
    params = dict(model.named_parameters())

    results = []
    for epoch in range(args.epochs):
        sparsity = epoch_sparsity(epoch, args)
        gen = stream_generator(device, 9, epoch)
        for _ in range(args.steps_per_epoch):
            train_step(state, train_ds, batch_size=tc.batch_size, label_len=cfg.label_len,
                       generator=gen)
            with torch.no_grad():
                assign_(params, apply_pruning(params, sparsity))
        split, nm = validate(model, val_ds, batch_size=tc.batch_size, label_len=cfg.label_len,
                             num_batches=4, stream=(9, 1 << 20, epoch))
        actual = measured_sparsity(params)
        results.append({"epoch": epoch, "sparsity": sparsity, "measured_sparsity": actual,
                        "val_nmse": nm})
        print(f"| epoch {epoch:3d} | sparsity {sparsity:.3f} "
              f"(measured {actual:.3f}) | valid nmse {nm:.4f}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(state, args.out, "pruned_", args.epochs)
    with open(os.path.join(args.out, "prune_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"sweep": "prune", "final": results[-1]}), flush=True)
    return results


if __name__ == "__main__":
    main()
