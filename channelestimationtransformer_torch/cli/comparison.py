"""Model-family comparison: RNN / GRU / LSTM / Transformer / Informer (the
counterpart of ``experiments/comparison.py``).

Reference: ``ComparisonLSTMvsRNNvsGRUvsTransformer/trainingScripts/Train*.py``:
train each family on the same dataset (the recurrent nets as teacher-forced
denoisers, loss on the last 10 slots of ``H_noise -> H``; the transformers
seq-to-seq), then sweep the evaluation SNR; per-model per-horizon NMSE, by
closed-loop rollout for the recurrent nets. It writes ``loss_<model>.pkl``
(the SNR -> split dict) and ``comparison.json`` under ``--out``, as the JAX
driver lays them out::

    python -m channelestimationtransformer_torch.cli.comparison --calibrated \\
        --ue-speed-kmh 5 --epochs 50 --train-samples 8192

Streams: the datasets from keys 0 (train) and 1 (1,024 validation samples),
a recurrent model's weights from seed 0 and its step ``i`` from ``(1, i)``,
its evaluation batches from ``(9, i)``; the transformers' validation at
each SNR from ``(11,)``. On the card the Informer takes the bd attention
kernels (the same architecture); the Transformer baseline has no kernel
route, as in JAX. ``--device`` goes beyond the JAX driver.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle

import numpy as np
import torch

from ..channel.cdl import add_channel_args, cdl_from_args
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, RecurrentConfig, TrainConfig, TransformerConfig
from ..core.metrics import nmse, nmse_split
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset, sample_windows
from ..models.informer import build_informer
from ..models.recurrent import build_recurrent
from ..models.transformer import build_transformer
from ..train.trainer import Trainer
from ._study import add_device_arg

RECURRENT = ("rnn", "gru", "lstm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compare the model families.")
    p.add_argument("--train-snr", type=float, default=21.0)
    p.add_argument("--snr-sweep", type=float, nargs="+",
                   default=[12, 13, 14, 15, 16, 17, 18, 19, 20, 21])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--train-samples", type=int, default=4096)
    add_channel_args(p)
    p.add_argument("--models", nargs="+",
                   default=["rnn", "gru", "lstm", "transformer", "informer"])
    p.add_argument("--out", default="weights/comparison")
    add_device_arg(p)
    return p


def train_recurrent(cell, train_ds, steps, lr=1e-3, seed=0, batch=64):
    """Teacher-forced denoiser training (reference ``TrainLSTM.py``): Adam
    at ``lr``, batches of 64 windows, the NMSE of the last 10 slots of the
    one-step-ahead output against the clean channel."""
    rcfg = RecurrentConfig(features=16, input_size=128, hidden_size=256, num_layers=2,
                           cell=cell)
    model = build_recurrent(rcfg, device=train_ds.device, seed=seed).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for i in range(steps):
        clean, noisy, _, _ = sample_windows(
            train_ds, batch, generator=stream_generator(train_ds.device, seed + 1, i))
        # out[t] estimates slot t from slots < t; denoising loss on the last 10.
        loss = nmse(model(noisy)[:, -10:], clean[:, -10:])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.eval()


@torch.no_grad()
def eval_recurrent(model, val_h, generator, pred_len, batch, seq_len, snr_db):
    """Per-horizon NMSE of one closed-loop rollout from ``H_seq`` against
    ``H_pred`` on ``batch`` windows of the validation channel at ``snr_db``."""
    ds = WindowDataset(h=val_h, seq_len=seq_len, pred_len=pred_len, snr_db=snr_db,
                       device=val_h.device)
    _, _, noisy, clean = sample_windows(ds, batch, generator=generator)
    return nmse_split(model.rollout(noisy, pred_len), clean)


def main(argv=None) -> dict:
    """Run the comparison; returns the results written to ``comparison.json``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(seq_len=25, label_len=10, pred_len=5,
                         use_pallas=device.type == "cuda")
    train_ds, val_ds = (
        make_window_dataset(key, model=cdl_from_args(args), num_samples=n, num_slots=100,
                            seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                            snr_db=args.train_snr, device=device)
        for key, n in ((0, args.train_samples), (1, 1024)))

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for name in args.models:
        print(f"=== {name} ===", flush=True)
        sweep = {}
        if name in RECURRENT:
            model = train_recurrent(name, train_ds, args.steps)
            for snr in args.snr_sweep:
                split = torch.stack([
                    eval_recurrent(model, val_ds.h, stream_generator(device, 9, i),
                                   cfg.pred_len, 256, cfg.seq_len, float(snr))
                    for i in range(4)])
                sweep[snr] = (split.double().cpu().numpy().sum(axis=0) / 4).tolist()
                print(f"SNR {snr}: {sweep[snr]}", flush=True)
        else:
            tc = TrainConfig(batch_size=256, num_epochs=args.epochs, lr=1e-3,
                             steps_per_epoch=100)
            if name == "informer":
                net = build_informer(cfg, device=device, seed=tc.seed)
            else:
                net = build_transformer(TransformerConfig(
                    seq_len=cfg.seq_len, label_len=cfg.label_len, pred_len=cfg.pred_len),
                    device=device, seed=tc.seed)
            trainer = Trainer(model=net, cfg=cfg, train_cfg=tc, train_data=train_ds,
                              val_data=val_ds, log=lambda s: None)
            trainer.fit()
            for snr in args.snr_sweep:
                trainer.val_data = dataclasses.replace(val_ds, snr_db=float(snr))
                val = trainer.run_validation(stream_generator(device, 11))
                sweep[snr] = [float(v) for v in np.asarray(val["split"].cpu())]
                print(f"SNR {snr}: {sweep[snr]}", flush=True)
        results[name] = sweep
        with open(os.path.join(args.out, f"loss_{name}.pkl"), "wb") as f:
            pickle.dump(results[name], f)

    with open(os.path.join(args.out, "comparison.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"sweep": "comparison", "models": list(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
