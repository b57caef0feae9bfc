"""Sweep runner: the reference's FullPrecision sbatch sweeps as one driver
(the counterpart of ``experiments/sweep.py``, with its ``SWEEPS``).

Reference: ``FullPrecision/{SNR,seq_len,dff,dmodel,attn,distil,label_len}.sbatch``,
each of which runs the trainer once per value of one hyperparameter. Each
variant runs ``cli.train_informer`` in a process of its own, and its output
is appended to one reference-parseable log::

    python -m channelestimationtransformer_torch.cli.sweep attn --epochs 50 \\
        --train-samples 16384 --calibrated --ue-speed-kmh 5 --lr 1e-3 --use-pallas

Flags the sweep does not know go to every ``train_informer`` run as they
are, in order.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SWEEPS = {
    # reference FullPrecision/SNR.sbatch
    "snr": [["--snr", str(v)] for v in (12, 14, 16, 18, 20, 21)],
    # the reference's sequence-length sweep (its sbatch is mislabelled "Dff")
    "seq_len": [["--seq-len", str(v)] for v in (25, 50, 75, 90)],
    "label_len": [["--label-len", str(v)] for v in (5, 10, 15, 20)],
    "d_ff": [["--d-ff", str(v)] for v in (64, 96, 128, 192, 256)],
    "d_model": [["--d-model", str(v)] for v in (64, 96, 128)],
    "attn": [["--attn", v] for v in ("full", "prob")],
    "distil": [[], ["--no-distil"]],
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("sweep", choices=sorted(SWEEPS))
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--train-samples", type=int, default=65536)
    p.add_argument("--log", default=None)
    # Unknown flags go on to train_informer as they are. There is no positional
    # catch-all: argparse would take a flag's value for it ("--ue-speed-kmh 5"
    # would lose its "5") and scramble the forwarded command.
    args, extra = p.parse_known_args(argv)

    log_path = args.log or os.path.join("weights", f"sweep_{args.sweep}.txt")
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    for variant in SWEEPS[args.sweep]:
        cmd = [sys.executable, "-m", "channelestimationtransformer_torch.cli.train_informer",
               "--epochs", str(args.epochs), "--train-samples", str(args.train_samples),
               *variant, *extra]
        print(f"=== {' '.join(cmd)} ===", flush=True)
        with open(log_path, "a") as logf:
            subprocess.run(cmd, stdout=logf, stderr=subprocess.STDOUT, check=True)
    print(f"Sweep '{args.sweep}' complete; parseable log at {log_path}")


if __name__ == "__main__":
    main()
