"""Train the Informer channel predictor (the counterpart of
``experiments/train_informer.py``).

Reference: ``FullPrecision/QuantizationAwareTraining.py`` and its sbatch
sweeps. It generates calibrated or reference CDL-B data on the device, beam
sweeps it onto 4 DFT beams, standardises and splits it, trains with
``Trainer.fit`` (reference-format logs), checkpoints, and writes
``result_<name>.json`` beside the checkpoints, with the JAX driver's flags,
names and keys::

    python -m channelestimationtransformer_torch.cli.train_informer --snr 20 --epochs 50 \\
        --train-samples 16384 --calibrated --ue-speed-kmh 5 --use-pallas
    python -m channelestimationtransformer_torch.cli.train_informer --device cpu \\
        --d-model 32 --d-ff 32 --e-layers 1 --d-layers 1 --epochs 1 --steps-per-epoch 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..channel.cdl import CDLModel
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device
from ..models.informer import build_informer
from ..train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..train.trainer import Trainer, create_train_state
from ..utils.tensorboard import MetricsWriter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the Informer channel predictor. The JAX driver's "
                    "--prng (its PRNG key implementation) has no counterpart: "
                    "the port's streams are torch.Generators.")
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--seq-len", type=int, default=90)
    p.add_argument("--label-len", type=int, default=10)
    p.add_argument("--pred-len", type=int, default=5)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--e-layers", type=int, nargs="+", default=[4, 3])
    p.add_argument("--d-layers", type=int, default=3)
    p.add_argument("--d-ff", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--attn", choices=["full", "prob"], default="full")
    p.add_argument("--no-distil", action="store_true")
    p.add_argument("--use-pallas", action="store_true",
                   help="hand-written CUDA attention kernels (bd_attention) in "
                        "train+eval instead of the plain torch path")
    p.add_argument("--pre-norm", action="store_true",
                   help="pre-LayerNorm residual blocks (from-scratch stability)")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--tensorboard", action="store_true",
                   help="log the reference's scalars (Loss/train, Loss/val, Loss/val1..5) "
                        "under runs/<name>: TensorBoard events, or events.jsonl where the "
                        "tensorboard package is missing")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--steps-per-epoch", type=int, default=226)
    p.add_argument("--log-every", type=int, default=22,
                   help="train-chunk size in steps (= host fetches per epoch: "
                        "steps/log_every)")
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="checkpoint cadence in epochs (reference: 100)")
    p.add_argument("--train-samples", type=int, default=8192)
    p.add_argument("--val-samples", type=int, default=2048)
    p.add_argument("--num-slots", type=int, default=100)
    p.add_argument("--slot-symbols", type=int, default=75,
                   help="OFDM symbols per sampled slot. 75 = the committed "
                        "reference generator (1.6 kHz); 14 = one 5G slot")
    p.add_argument("--ue-speed-kmh", type=float, default=None,
                   help="UE mobility. Default: 30, or the fitted 5.5 under "
                        "--calibrated. An explicit value under --calibrated is "
                        "tagged _cal_v<speed> in the run name")
    p.add_argument("--calibrated", action="store_true",
                   help="use CDLModel.calibrated(): the parity-calibrated slot "
                        "period (160.42 us) + fitted UE speed (--ue-speed-kmh, "
                        "default 5.5 in this mode)")
    p.add_argument("--lr-schedule", choices=["warmup_cosine", "constant"],
                   default="warmup_cosine",
                   help="'constant' replicates the reference SNR-sweep runs "
                        "(lr held at 1e-3, FullPrecision/Figures/SNR.txt)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="weights")
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--preload", type=str, default=None,
                   help="checkpoint path, or 'latest' (reference preload modes, "
                        "FullPrecision/QuantizationAwareTraining.py:189-202)")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the newest checkpoint (step-exact)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, and raise without "
                        "one; 'cpu' runs the plain CPU path)")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def run_name(args, cfg: InformerConfig, ue_speed: float) -> str:
    """The reference model-name line's name (parsed by ``Figures/parse.py``),
    as the JAX driver builds it."""
    return (
        f"ei_{cfg.enc_in}_di_{cfg.dec_in}_co_{cfg.c_out}_sl_{cfg.seq_len}"
        f"_ll_{cfg.label_len}_pl_{cfg.pred_len}_f_{cfg.factor}_dm_{cfg.d_model}"
        f"_nh_{cfg.n_heads}_el_{list(cfg.e_layers)}_dl_{cfg.d_layers}"
        f"_df_{cfg.d_ff}_do_{cfg.dropout}_at_{cfg.attn}_em_fixed_ac_gelu_{int(args.snr)}"
        + ("_cal" if args.calibrated else
           (f"_ss{args.slot_symbols}" if args.slot_symbols != 75 else ""))
        + (f"_v{ue_speed:g}"
           if (args.ue_speed_kmh is not None if args.calibrated
               else ue_speed != 30.0) else "")
        + ("_prenorm" if args.pre_norm else "")
        + ("_bf16" if args.dtype == "bfloat16" else "")
        + ("_pallas" if args.use_pallas else "")
        + ("_nodistil" if args.no_distil else "")
        + (f"_{args.tag}" if args.tag else "")
    )


def main(argv=None) -> dict:
    """Run the driver; returns the result written to ``result_<name>.json``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ue_speed = (args.ue_speed_kmh if args.ue_speed_kmh is not None
                else (5.5 if args.calibrated else 30.0))
    cfg = InformerConfig(
        seq_len=args.seq_len,
        label_len=args.label_len,
        pred_len=args.pred_len,
        d_model=args.d_model,
        n_heads=args.n_heads,
        e_layers=tuple(args.e_layers),
        d_layers=args.d_layers,
        d_ff=args.d_ff,
        dropout=args.dropout,
        attn=args.attn,
        distil=not args.no_distil,
        pre_norm=args.pre_norm,
        dtype=args.dtype,
        use_pallas=args.use_pallas,
    )
    tc = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        steps_per_epoch=args.steps_per_epoch,
        seed=args.seed,
        schedule=args.lr_schedule,
        log_every=args.log_every,
        checkpoint_every_epochs=args.checkpoint_every,
        checkpoint_dir=args.out,
    )
    name = run_name(args, cfg, ue_speed)
    print(f"Model_name:  {name}", flush=True)
    print("Using device: " + (torch.cuda.get_device_name(device) if device.type == "cuda"
                              else str(device)), flush=True)
    # The weights come from their own generator (seed), as in JAX.
    model = build_informer(cfg, device=device, seed=args.seed)

    t0 = time.time()
    if args.calibrated:
        cdl = CDLModel.calibrated(ue_speed_kmh=ue_speed)
    else:
        cdl = CDLModel(sampling_frequency=120e3 / args.slot_symbols, ue_speed_ms=ue_speed / 3.6)
    # The two datasets' streams, keyed (seed + 100, 0) and (seed + 100, 1): the
    # counterpart of JAX's split of key(seed + 100), apart from the training
    # and validation streams (seed + 1, epoch, ...).
    train_ds, val_ds = (
        make_window_dataset((args.seed + 100, i), model=cdl, num_samples=n,
                            num_slots=args.num_slots, seq_len=cfg.seq_len,
                            pred_len=cfg.pred_len, snr_db=args.snr, device=device)
        for i, n in enumerate((args.train_samples, args.val_samples)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Dataset generated in {time.time() - t0:.1f}s "
          f"(train {tuple(train_ds.h.shape)}, val {tuple(val_ds.h.shape)})", flush=True)

    writer = MetricsWriter(os.path.join("runs", name)) if args.tensorboard else None
    trainer = Trainer(model=model, cfg=cfg, train_cfg=tc, train_data=train_ds, val_data=val_ds,
                      metrics_writer=writer)
    start_epoch = 0
    if args.preload or args.resume:
        path = (latest_checkpoint(args.out, f"tmodel_{name}_")
                if (args.resume or args.preload == "latest") else args.preload)
        if path:
            trainer.state, pre_epoch, _ = load_checkpoint(path, trainer.state)
            print(f"Preloading model {path} (epoch {pre_epoch})", flush=True)
            if args.resume and pre_epoch:
                start_epoch = int(pre_epoch)
            else:
                # Fine-tune: a fresh optimizer at schedule step 0 (a restored
                # optimizer carries the old run's step, which would put the new
                # cosine past its end: lr 0).
                trainer.state = create_train_state(trainer.model, tc)
        else:
            print("No checkpoint found to preload", flush=True)
    trainer.checkpoint_tag = f"tmodel_{name}_"
    history = trainer.fit(start_epoch=start_epoch)
    if writer is not None:
        writer.close()

    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(trainer.state, args.out, f"tmodel_{name}_", args.epochs)
    result = {
        "name": name,
        "snr": args.snr,
        "epochs": args.epochs,
        "final_val_nmse": history[-1]["nmse"],
        "final_val_nmse_db": float(10 * np.log10(history[-1]["nmse"])),
        "final_val_split": [float(v) for v in history[-1]["split"]],
        "history_nmse": [h["nmse"] for h in history],
    }
    with open(os.path.join(args.out, f"result_{name}.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "history_nmse"}), flush=True)
    return result


if __name__ == "__main__":
    main()
