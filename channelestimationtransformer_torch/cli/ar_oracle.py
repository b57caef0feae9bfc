"""AR(p) predictability oracle: the data-driven NMSE bound for a dataset
(the counterpart of ``experiments/ar_oracle.py``).

For every evaluation window this fits a per-window complex AR(p) predictor on
the *noisy* history by ridge least squares and rolls it out closed-loop for
``pred_len`` slots, scoring against the clean future: the best a memory-p
linear predictor could do on exactly the task the transformer solves, so a
model's NMSE can be read as a fraction of the linear-predictability bound.

JAX's driver solves row by row in numpy on the host. Here all ``B * F/2``
rows are solved at once (``torch.linalg.solve`` over a batch of complex
``order x order`` systems) and rolled out together, on the card unless
``--device cpu``, in JAX's precisions: the normal equations' products in
complex64, the ridge system and its solution in complex128, the
predictions kept as complex64. The windows come from the port's channel
generator (keys 1234 for the dataset, 5678 for the windows)::

    python -m channelestimationtransformer_torch.cli.ar_oracle --snr 12 14 16 18 20 21 \\
        --slot-symbols 14 --out weights/ar_oracle.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..channel.cdl import cdl_from_args
from ..channel.dataset import make_window_dataset
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import sample_windows
from ._study import add_device_arg


def _complex_rows(x: torch.Tensor) -> torch.Tensor:
    """Packed ri ``[B, T, F]`` -> complex64 rows ``[B * F/2, T]`` (sample-major)."""
    b, t, f = x.shape
    z = torch.complex(x[..., 0::2], x[..., 1::2])  # [B, T, F/2]
    return z.transpose(1, 2).reshape(b * (f // 2), t)


def ar_oracle_nmse(noisy_hist, clean_future, order: int, ridge: float = 1e-3):
    """Per-window complex AR(order) fit and closed-loop rollout, batched.

    noisy_hist: ``[B, L, F]`` packed ri features; clean_future: ``[B, P, F]``
    (tensors, or arrays taken to the CPU). Returns (scalar NMSE, per-horizon
    NMSE list of P)."""
    x = _complex_rows(torch.as_tensor(noisy_hist, dtype=torch.float32))
    y = _complex_rows(torch.as_tensor(clean_future, dtype=torch.float32).to(x.device))
    rows, l = x.shape
    p_len = y.shape[1]
    a_mat = x.unfold(1, order, 1)[:, : l - order]  # [rows, l - order, order], oldest -> newest
    b_vec = x[:, order:]
    a_h = a_mat.conj().transpose(1, 2)
    eye = torch.eye(order, dtype=torch.complex128, device=x.device)
    g = (a_h @ a_mat).to(torch.complex128) + ridge * eye
    rhs = (a_h @ b_vec.unsqueeze(-1)).to(torch.complex128)
    w = torch.linalg.solve(g, rhs).squeeze(-1)  # [rows, order]
    hist = x[:, -order:].to(torch.complex128)
    preds = []
    for _ in range(p_len):
        nxt = (hist[:, -order:] * w).sum(dim=1)
        preds.append(nxt.to(torch.complex64))
        hist = torch.cat([hist, nxt[:, None]], dim=1)
    preds = torch.stack(preds, dim=1)
    err = (preds - y).abs().square()
    pwr = y.abs().square()
    scalar = float(err.sum() / pwr.sum())
    b = rows // (noisy_hist.shape[-1] // 2)
    split = err.reshape(b, -1, p_len).sum(dim=(0, 1)) / pwr.reshape(b, -1, p_len).sum(dim=(0, 1))
    return scalar, [float(v) for v in split]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AR(p) oracle NMSE of the generated channel.")
    p.add_argument("--snr", type=float, nargs="+", default=[12, 21])
    p.add_argument("--slot-symbols", type=int, default=14)
    p.add_argument("--ue-speed-kmh", type=float, default=None)
    p.add_argument("--calibrated", action="store_true",
                   help="use CDLModel.calibrated() (parity configuration)")
    p.add_argument("--order", type=int, default=30)
    p.add_argument("--windows", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=90)
    p.add_argument("--pred-len", type=int, default=5)
    p.add_argument("--out", default="weights/ar_oracle.json")
    add_device_arg(p)
    return p


def oracle_rows(args, device, *, dataset_key: int = 1234, log=print):
    """``{snr: {"nmse", "nmse_db", "split"}}`` for ``args``' SNRs on the
    dataset keyed ``dataset_key`` (the windows keyed 5678)."""
    rows = {}
    for snr in args.snr:
        ds = make_window_dataset(dataset_key, model=cdl_from_args(args), num_samples=1024,
                                 num_slots=100, seq_len=args.seq_len, pred_len=args.pred_len,
                                 snr_db=snr, device=device)
        _, _, hist, future = sample_windows(ds, args.windows,
                                            generator=stream_generator(device, 5678))
        scalar, split = ar_oracle_nmse(hist, future, args.order)
        rows[str(snr)] = {
            "nmse": scalar,
            "nmse_db": float(10 * np.log10(scalar)),
            "split": split,
        }
        log(json.dumps({"snr": snr, "oracle_nmse": scalar,
                        "oracle_db": round(10 * np.log10(scalar), 2),
                        "split": [round(v, 5) for v in split]}))
    return rows


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    results = {
        "order": args.order, "slot_symbols": args.slot_symbols,
        "calibrated": bool(args.calibrated),
        "ue_speed_kmh": args.ue_speed_kmh,
        "seq_len": args.seq_len,
        "snr": oracle_rows(args, device, log=lambda line: print(line, flush=True)),
    }

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
