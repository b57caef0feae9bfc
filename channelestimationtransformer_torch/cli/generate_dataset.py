"""Dataset generation driver (the counterpart of ``experiments/generate_dataset.py``).

Reference: ``GenerateDatasets/generateDataset.sbatch:12-51``, which repeats
the Sionna -> MATLAB -> pickle chain to grow the dataset, appending to
``Datasets/Seq_Len_{slots}_Beamforming2_CDLB{,__validate}.pickle``.

This writes pickles in the reference's exact format (appended, 80/20 split)
so reference tooling can read them, or ``--npz`` for the packed layout::

    python -m channelestimationtransformer_torch.cli.generate_dataset --num-samples 6400
    python -m channelestimationtransformer_torch.cli.generate_dataset --device cpu --num-samples 64
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..channel.cdl import CDLModel
from ..channel.dataset import generate_beamformed_dataset, train_val_split


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-samples", type=int, default=6400)
    p.add_argument("--num-slots", type=int, default=100)
    p.add_argument("--num-bs-ant", type=int, default=64)
    p.add_argument("--num-ut-ant", type=int, default=2)
    p.add_argument("--speed-kmh", type=float, default=30.0)
    p.add_argument("--slot-symbols", type=int, default=75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="Datasets")
    p.add_argument("--npz", action="store_true", help="write packed .npz instead of pickle")
    p.add_argument("--device", default=None,
                   help="torch device to generate on (default: the CUDA card; "
                        "'cpu' runs the plain CPU path)")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    model = CDLModel(
        num_bs_ant=args.num_bs_ant,
        num_ut_ant=args.num_ut_ant,
        ue_speed_ms=args.speed_kmh / 3.6,
        sampling_frequency=120e3 / args.slot_symbols,
    )
    h = generate_beamformed_dataset(
        args.seed, model=model, num_samples=args.num_samples, num_slots=args.num_slots,
        device=args.device,
    ).cpu().numpy()  # [N, slots, Nr, Nt, 2] ri
    os.makedirs(args.out_dir, exist_ok=True)

    if args.npz:
        n, slots, nr, nt, _ = h.shape
        train, val = train_val_split(h.reshape(n, slots, nr * nt * 2))
        path = os.path.join(args.out_dir, f"Seq_Len_{args.num_slots}_Beamforming_CDLB.npz")
        np.savez(path, train=train, val=val)
        print(f"Wrote {path}: train {train.shape}, val {val.shape}")
        return

    train, val = train_val_split((h[..., 0] + 1j * h[..., 1]).astype(np.complex64))
    for name, arr in [
        (f"Seq_Len_{args.num_slots}_Beamforming2_CDLB.pickle", train),
        (f"Seq_Len_{args.num_slots}_Beamforming2_CDLB__validate.pickle", val),
    ]:
        path = os.path.join(args.out_dir, name)
        # Append to existing data like the reference post-MATLAB script.
        if os.path.exists(path):
            with open(path, "rb") as f:
                existing = np.asarray(pickle.load(f))
            arr = np.concatenate([existing, arr], axis=0)
        with open(path, "wb") as f:
            pickle.dump(arr, f)
        print(f"Wrote {path}: {arr.shape}")


if __name__ == "__main__":
    main()
