"""Fast-fading-cluster calibration (the counterpart of
``experiments/calibrate_fast.py``, flag for flag).

The reference's figure logs split into a smooth cluster (matched by
``cli/calibrate_channel.py``) and a fast-fading one (``sequence_len.txt``,
``label_length.txt``, ``attn.txt``, ``dmodel.txt``, the LSQ study's FP32
anchor). This driver fits the fast cluster's channel the same way: the
held-out ensemble Wiener bound of the 5 future slots from the noisy
``seq_len``-slot history, against the committed rows, over two families:

1. **UE speed** at the recovered 160.42 us slots, fitted to the
   ``sequence_len.txt`` curve at SNR 21 with one shared model-above-bound
   gap >= 0 dB; a bound above a committed row is infeasible;
2. **slot period** at 30 km/h (slot-symbol grid), against the LSQ anchor's
   5th horizon and the ``dmodel.txt`` rows.

The channel comes from the port's generator on the card (``--device cpu``
for the CPU), the bounds are computed there in JAX's complex64::

    python -m channelestimationtransformer_torch.cli.calibrate_fast \\
        --out weights/calibration_fast.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..channel.cdl import CDLModel
from ..channel.dataset import generate_beamformed_dataset
from ..core.runtime import resolve_device
from ._study import add_device_arg
from .calibrate_channel import SLOT_PERIOD, normalized

# Fast-cluster committed rows (last "valid loss" per section; the LSQ anchor
# is the 5th-horizon loss, LSQ.py:44 plots arr.flatten()[4]).
REF_SEQ_LEN = {25: 0.349, 50: 0.177, 75: 0.102, 90: 0.080}  # sequence_len.txt, 100 ep
REF_LABEL_LEN = {5: 0.0722, 10: 0.0853, 15: 0.0820, 20: 0.0716}  # label_length.txt
REF_ATTN = {"full": 0.0964, "prob": 0.1463}  # attn.txt, 50 ep
REF_DMODEL = {64: 0.326, 96: 0.302, 128: 0.277}  # dmodel.txt, 50 ep
REF_LSQ_FP32_H5 = 0.3466  # PaperFigures/LSQ/LSQ.py:44 (5th horizon)

SNR_DB = 21.0
SEQ_GRID = (25, 50, 75, 90)


def generate(model: CDLModel, n: int, t: int, seed: int = 0, *, device=None,
             draws=None) -> torch.Tensor:
    """``n`` normalised samples of ``t`` slots of ``model`` from the port's
    generator keyed by ``seed`` (``draws`` replace its draws)."""
    h = generate_beamformed_dataset(seed, model=model, num_samples=n, num_slots=t,
                                    batch_size=min(n, 512), device=device, draws=draws)
    return normalized(h)


def wiener_bound(x: torch.Tensor, seq: int, snr_db: float = SNR_DB):
    """Optimal-linear 5-slot-ahead prediction NMSE from the noisy trailing
    ``seq`` slots; returns (mean NMSE, per-horizon NMSE list).

    The filter is fitted on one half of the ensemble and its residual is
    evaluated in closed form against the held-out half's covariances (an
    in-sample closed form at these dimensions is optimistically biased)."""
    n, t, f = x.shape
    pred = 5
    yobs = x[:, t - pred - seq:t - pred].reshape(n, -1)
    futf = x[:, t - pred:].reshape(n, -1)
    h = n // 2
    s2 = 10 ** (-snr_db / 10)
    eye = torch.eye(yobs.shape[1], dtype=x.dtype, device=x.device)

    def cov(a, b):
        return a.conj().T @ b / a.shape[0]

    cyy_tr = cov(yobs[:h], yobs[:h])
    cxy_tr = cov(futf[:h], yobs[:h])
    w = torch.linalg.solve((cyy_tr + s2 * eye).T, cxy_tr.T).T  # [fut_dim, obs_dim]

    cyy_te = cov(yobs[h:], yobs[h:])
    cxy_te = cov(futf[h:], yobs[h:])
    resid = w @ (cyy_te + s2 * eye) @ w.conj().T
    per_col = (torch.mean(futf[h:].abs() ** 2, dim=0)
               - 2 * torch.real(torch.einsum("ij,ij->i", w, cxy_te.conj()))
               + torch.real(torch.diagonal(resid)))
    per_h = per_col.reshape(pred, f).sum(dim=1)
    denom = torch.mean(futf[h:].reshape(-1, pred, f).abs() ** 2, dim=(0, 2)) * f
    per_h_nmse = torch.clamp_min(per_h / denom, 0.0)
    total = float(max(float(per_col.sum()), 0.0)
                  / (float(torch.mean(futf[h:].abs() ** 2)) * futf.shape[1]))
    return total, [float(v) for v in per_h_nmse]


def fit_gap_cost(bounds: dict, refs: dict):
    """Shared gap (model above bound, >= 0 dB) + RMS residual; a bound above
    any committed row makes the candidate infeasible (cost inf)."""
    b_db = np.array([10 * np.log10(bounds[k]) for k in refs])
    r_db = np.array([10 * np.log10(refs[k]) for k in refs])
    if np.any(b_db > r_db + 0.25):  # small tolerance for run noise
        return None, float("inf")
    gap = max(0.0, float(np.mean(r_db - b_db)))
    rms = float(np.sqrt(np.mean((b_db + gap - r_db) ** 2)))
    return gap, rms


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Calibrate the fast-fading cluster's channel.")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--speeds", type=str, default="10,15,20,25,30,40,60,90")
    p.add_argument("--slot-symbols", type=str, default="25,40,55,75")
    p.add_argument("--out", type=str, default="weights/calibration_fast.json")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    result = {
        "snr_db": SNR_DB,
        "slot_period_us": SLOT_PERIOD * 1e6,
        "ref_rows": {
            "seq_len": REF_SEQ_LEN, "label_len": REF_LABEL_LEN,
            "attn": REF_ATTN, "d_model": REF_DMODEL,
            "lsq_fp32_anchor_h5": REF_LSQ_FP32_H5,
        },
    }

    # --- Family 1: speed grid at the recovered slot geometry ---
    rows = {}
    best, best_cost, best_gap = None, np.inf, None
    for v in [float(s) for s in args.speeds.split(",") if s]:
        m = CDLModel(sampling_frequency=1.0 / SLOT_PERIOD, ue_speed_ms=v / 3.6)
        x = generate(m, args.n, 95, seed=2, device=device)
        bounds, per_h90 = {}, None
        for seq in SEQ_GRID:
            tot, per_h = wiener_bound(x, seq)
            bounds[seq] = tot
            if seq == 90:
                per_h90 = per_h
        gap, cost = fit_gap_cost(bounds, REF_SEQ_LEN)
        rows[str(v)] = {
            "bound_seq": {str(k): round(b, 5) for k, b in bounds.items()},
            "bound_seq90_per_horizon": [round(b, 5) for b in per_h90],
            "gap_db": None if gap is None else round(gap, 2),
            "rms_db": None if not np.isfinite(cost) else round(cost, 2),
        }
        if cost < best_cost:
            best, best_cost, best_gap = v, cost, gap
        print(f"v={v} km/h bounds={rows[str(v)]['bound_seq']} "
              f"gap={rows[str(v)]['gap_db']} rms={rows[str(v)]['rms_db']}", flush=True)
    result["speed_grid"] = rows
    result["fitted_speed_kmh"] = best
    result["fitted_gap_db"] = round(best_gap, 2) if best_gap is not None else None
    result["fitted_rms_db"] = round(best_cost, 2) if np.isfinite(best_cost) else None

    # --- Family 2: slot-symbols grid at 30 km/h vs the dmodel/LSQ cluster ---
    ss_rows = {}
    ss_best, ss_cost = None, np.inf
    for ss in [int(s) for s in args.slot_symbols.split(",") if s]:
        m = CDLModel(sampling_frequency=120e3 / ss, ue_speed_ms=30.0 / 3.6)
        x = generate(m, args.n, 95, seed=3, device=device)
        tot, per_h = wiener_bound(x, 90)
        # dmodel rows are 50-epoch means; the LSQ anchor is the 5th horizon.
        d_db = 10 * np.log10(per_h[4] / REF_LSQ_FP32_H5)
        ss_rows[str(ss)] = {
            "bound_seq90": round(tot, 5),
            "bound_per_horizon": [round(b, 5) for b in per_h],
            "lsq_anchor_delta_db": round(float(d_db), 2),
            "feasible_vs_dmodel": bool(tot <= min(REF_DMODEL.values()) * 1.06),
        }
        cost = abs(d_db)
        if ss_rows[str(ss)]["feasible_vs_dmodel"] and cost < ss_cost:
            ss_best, ss_cost = ss, cost
        print(f"ss={ss} bound90={tot:.4f} h5={per_h[4]:.4f} d_lsq={d_db:+.2f} dB", flush=True)
    result["slot_symbols_grid"] = ss_rows
    result["fitted_slot_symbols_30kmh"] = ss_best

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({
        "fitted_speed_kmh": best,
        "fitted_rms_db": result["fitted_rms_db"],
        "fitted_gap_db": result["fitted_gap_db"],
        "fitted_slot_symbols_30kmh": ss_best,
    }))
    return result


if __name__ == "__main__":
    main()
