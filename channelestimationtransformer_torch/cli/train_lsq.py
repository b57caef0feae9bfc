"""LSQ / LSQ-fibbinary quantization-aware training from an FP32 checkpoint
(the counterpart of ``experiments/train_lsq.py``).

Reference: ``QuantizationStudy/LSQ/TrainInformerLSQ.py`` and
``QuantizationStudy/LSQFonacci/TrainInformerLSQ.py``. For each nbits from
``--nbits-min`` to ``--nbits-max`` it builds the flagship InformerStack
(``attn="full"``) with every attention projection and FFN layer LSQ-quantized
(``--fibbinary``: snapped onto the fibbinary codebook), overlays the FP32
weights of ``--checkpoint`` (a checkpoint of ``cli.train_informer``;
``train/checkpoint.py:load_weights_overlay``: each ``step_size`` keeps the
value it got from the model's own initial weights, ``models/informer_lsq.py``),
trains at lr 1e-4 on the data
keyed 100 and 101 (2,048 validation samples), checkpoints as
``lsq[fib]_n<nbits>_<epochs>.pt`` and writes ``lsq[_fibbinary]_results.json``
after every nbits, merged with the committed artifact
(``experiments/artifacts``) and any earlier file in ``--out``::

    python -m channelestimationtransformer_torch.cli.train_lsq --fibbinary \\
        --checkpoint weights/tmodel_<name>_50.pt --calibrated --use-pallas

Two flags go beyond the JAX driver: ``--device`` (the card unless the CPU is
asked for) and ``--use-pallas``, off by default as in JAX, whose LSQ
training runs no Pallas kernel. With it each LSQ-fibbinary layer snaps
through the nearest-codeword kernel (its LSQ mode forward, the snap mode in
the backward) and attention goes through the bd kernels.

``main(argv, mesh=...)`` trains over a ``(data, model, seq)`` mesh of a
process group the caller joined: each rank overlays its rows of the FP32
checkpoint's sharded weights, and global rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib

import torch.distributed as dist

from ..channel.cdl import add_channel_args, cdl_from_args
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device
from ..models.informer_lsq import build_informer_lsq
from ..train.checkpoint import load_weights_overlay
from ..train.trainer import Trainer

# The JAX package's committed LSQ results, which each run's rows extend.
ARTIFACTS = pathlib.Path(__file__).resolve().parents[2] / "experiments" / "artifacts"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LSQ / LSQ-fibbinary quantization-aware training from an FP32 "
                    "checkpoint.")
    p.add_argument("--checkpoint", default=None, help="pretrained FP32 checkpoint")
    p.add_argument("--nbits-min", type=int, default=8)
    p.add_argument("--nbits-max", type=int, default=11)
    p.add_argument("--fibbinary", action="store_true")
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--steps-per-epoch", type=int, default=226)
    p.add_argument("--train-samples", type=int, default=8192)
    add_channel_args(p)
    p.add_argument("--out", default="weights")
    p.add_argument("--use-pallas", action="store_true",
                   help="the nearest-codeword kernel for the fibbinary snap and the bd "
                        "attention kernels, instead of the plain torch path")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, and raise without one; "
                        "'cpu' runs the plain CPU path)")
    return p


def main(argv=None, *, mesh=None) -> dict:
    """Run the driver; returns the results (every row, old and new).
    ``mesh``: train over it (module docstring)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # Merge with prior rows (the committed artifact, then an earlier file in
    # --out), so a run widens the study; written after every nbits.
    name = "lsq_fibbinary" if args.fibbinary else "lsq"
    out_path = os.path.join(args.out, f"{name}_results.json")
    results = {}
    for prior in (ARTIFACTS / f"{name}_results.json", out_path):
        if os.path.exists(prior):
            with open(prior) as f:
                results.update(json.load(f))

    os.makedirs(args.out, exist_ok=True)
    cfg = InformerConfig(attn="full", use_pallas=args.use_pallas)
    tc = TrainConfig(lr=1e-4, num_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    # The JAX driver draws both datasets from keys 100 and 101 for each nbits;
    # a dataset is a function of its key, so they are drawn once here.
    train_ds, val_ds = (
        make_window_dataset(key, model=cdl_from_args(args), num_samples=n, num_slots=100,
                            seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=args.snr,
                            device=device)
        for key, n in ((100, args.train_samples), (101, 2048)))
    for nbits in range(args.nbits_min, args.nbits_max + 1):
        model = build_informer_lsq(cfg, nbits=nbits, fibbinary=args.fibbinary, device=device,
                                   seed=tc.seed)
        trainer = Trainer(model=model, cfg=cfg, train_cfg=tc, train_data=train_ds,
                          val_data=val_ds, mesh=mesh)
        if args.checkpoint:
            load_weights_overlay(args.checkpoint, trainer.model)
            print(f"Preloaded FP32 weights from {args.checkpoint}", flush=True)

        history = trainer.fit()
        tag = f"lsq{'fib' if args.fibbinary else ''}_n{nbits}"
        trainer.save(args.out, f"{tag}_", args.epochs)
        results[tag] = {
            "nbits": nbits,
            "final_val_nmse": history[-1]["nmse"],
            "final_val_split": [float(v) for v in history[-1]["split"]],
            # Rows are curve-comparable only when they preload the same FP32 checkpoint.
            "preload": os.path.basename(args.checkpoint) if args.checkpoint else None,
        }
        print(json.dumps(results[tag]), flush=True)
        if mesh is None or dist.get_rank() == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
