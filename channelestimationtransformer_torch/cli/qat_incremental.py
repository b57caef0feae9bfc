"""Incremental (progressive) quantization-aware training (the counterpart
of ``experiments/qat_incremental.py``).

Reference: ``QuantizationStudy/QuantizationAwareTraining/QuantizationAwareTraining.py``
(and the Fibonacci variant ``...Fibonacci/ParallelExecution.py``): wl 2,
fl -2; a fraction schedule per rounding (``:369-379``); at each fraction
10 epochs in which every optimizer step is followed by the partial weight
quantization at that fraction; ``--setting full`` quantizes every weight
after every step for 70 epochs. It writes ``qat_<tag>.json``, the
checkpoint ``qat_<tag>_<len(schedule)>.pt`` and a final JSON line::

    python -m channelestimationtransformer_torch.cli.qat_incremental --use-pallas \\
        --checkpoint weights/tmodel_<name>_50.pt --rounding proximal --codebook fibonacci \\
        --calibrated --ue-speed-kmh 5 --train-samples 16384

After the preload the optimizer starts afresh at schedule step 0, with the
JAX driver's ``TrainConfig(lr=1e-4)``: 100 epochs of 226 steps, so the
warmup-cosine schedule reaches 0 at step 22,600 and a partial run of 40,680
or 45,200 steps trains its last fractions at lr 0, where only the
quantization acts (as the JAX driver does). Each step's transform is one
``FixedPointPartialWeightQuant`` / ``FibbinaryPartialWeightQuant`` /
``FixedPointWeightQuant`` over the 72 weights (``apply_weight_quant``: one
kernel launch and one sort per numel class), written into the same
``Parameter`` objects (``assign_``), so Adam keeps its moments. Training
step ``s`` of epoch ``e`` at fraction ``f`` draws its batch, noise,
dropout and stochastic subset from the stream ``(3, f, e)``; the
fraction's 8 validation batches from ``(3, f, 2**20, i)``.
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
from ..ops.quant import (
    FibbinaryPartialWeightQuant,
    FixedPointPartialWeightQuant,
    FixedPointWeightQuant,
    apply_weight_quant,
    assign_,
    build_weight_quant_settings,
)
from ..train.checkpoint import save_checkpoint
from ..train.trainer import train_step
from ._study import add_port_args, datasets, flagship_state, validate

# Reference fraction schedules (QuantizationAwareTraining.py:369-379).
SCHEDULES = {
    "proximal": [0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 0.98, 0.99,
                 0.995, 0.998, 0.999, 0.9995, 0.9998, 0.9999, 1.0],
    "stochastic": [0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5,
                   0.55, 0.60, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0],
    "distant": [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25,
                0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Incremental quantization-aware training.")
    p.add_argument("--checkpoint", default=None, help="pretrained FP32 checkpoint")
    p.add_argument("--wl", type=int, default=2)
    p.add_argument("--fl", type=int, default=None, help="default wl-4")
    p.add_argument("--rounding", choices=["proximal", "stochastic", "distant"],
                   default="proximal")
    p.add_argument("--setting", choices=["partial", "full"], default="partial")
    p.add_argument("--codebook", choices=["fixed", "fibonacci"], default="fixed")
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--epochs-per-step", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=226)
    p.add_argument("--train-samples", type=int, default=8192)
    add_channel_args(p)
    p.add_argument("--out", default="weights")
    add_port_args(p)
    return p


def weight_transform(args, fl: int):
    """The per-step transform and the fraction schedule of ``args``."""
    if args.setting == "partial":
        cls = (FibbinaryPartialWeightQuant if args.codebook == "fibonacci"
               else FixedPointPartialWeightQuant)
        return cls(args.wl, fl, args.rounding), SCHEDULES[args.rounding], args.epochs_per_step
    rounding = "stochastic" if args.rounding == "stochastic" else "nearest"
    return FixedPointWeightQuant(args.wl, fl, rounding), [1.0], 70


def main(argv=None) -> list:
    """Run the schedule; returns the per-fraction results."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    fl = args.fl if args.fl is not None else args.wl - 4
    cfg = InformerConfig(use_pallas=args.use_pallas)
    tc = TrainConfig(lr=1e-4)
    state, _ = flagship_state(cfg, tc, device, args.checkpoint)
    if args.checkpoint:
        print(f"Preloaded {args.checkpoint}", flush=True)
    qfn, schedule, epochs_per_step = weight_transform(args, fl)
    model = state.model
    params = dict(model.named_parameters())
    settings = build_weight_quant_settings(model.state_dict(), qfn)
    print(f"Quantizing {len(settings)} weight tensors; wl={args.wl} fl={fl} "
          f"{args.rounding}/{args.setting}/{args.codebook}", flush=True)
    train_ds, val_ds = datasets(args, cfg, device, (100, args.train_samples), (101, 2048))

    results = []
    for f, pct in enumerate(schedule):
        for epoch in range(epochs_per_step):
            gen = stream_generator(device, 3, f, epoch)
            for _ in range(args.steps_per_epoch):
                train_step(state, train_ds, batch_size=tc.batch_size, label_len=cfg.label_len,
                           generator=gen)
                with torch.no_grad():
                    assign_(params, apply_weight_quant(params, settings, percentage=pct,
                                                       generator=gen))
        split, nm = validate(model, val_ds, batch_size=tc.batch_size, label_len=cfg.label_len,
                             num_batches=8, stream=(3, f, 1 << 20))
        results.append({"fraction": pct, "val_nmse": nm, "val_split": split})
        print(f"| fraction {pct} | valid nmse {nm:.4f}", flush=True)

    tag = f"wl{args.wl}_fl{fl}_{args.rounding}_{args.setting}_{args.codebook}"
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(state, args.out, f"qat_{tag}_", len(schedule))
    with open(os.path.join(args.out, f"qat_{tag}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"sweep": "qat", "tag": tag, "final": results[-1]}), flush=True)
    return results


if __name__ == "__main__":
    main()
