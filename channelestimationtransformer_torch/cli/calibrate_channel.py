"""Channel-generator calibration against the reference's committed evidence
(the counterpart of ``experiments/calibrate_channel.py``, flag for flag).

Two prongs, as JAX's driver:

1. **Slot geometry**: the lag-correlation curve and Hankel effective rank
   of the reference's one stored channel sample (``MimoSimulation/channel.pickle``
   in the reference checkout, 14-symbol slots of a (16 + 6) / 1.92 MHz grid)
   against the port's generator at the same geometry. JAX's driver reads the
   pickle at a fixed path and skips this prong when it is absent; here
   ``--pickle`` names it, and without it the prong is skipped likewise.
2. **UE speed**: fitted so that the per-SNR ensemble Wiener bound (the
   optimal linear predictor of the 5 future slots from the 90 noisy past
   ones, in closed form over the generated ensemble) reproduces the
   reference's final SNR-sweep table.

The channel comes from the port's generator on the card (``--device cpu``
for the CPU); the statistics run there too, in JAX's complex64::

    python -m channelestimationtransformer_torch.cli.calibrate_channel --speeds 4,5,6,30 \\
        --out weights/calibration.json
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..channel.cdl import CDLModel
from ..channel.dataset import generate_beamformed_dataset
from ..core.runtime import resolve_device
from ._study import add_device_arg

REF_SNR_TABLE = {12: 0.0282, 14: 0.0188, 16: 0.0195, 18: 0.0128, 20: 0.0074}
SLOT_PERIOD = 14.0 * (16 + 6) / (16 * 120e3)  # 160.42 us (PlotChannel.py grid)


def lag_curve(x: torch.Tensor, lags=(1, 2, 3, 5, 10)) -> dict:
    """Mean-removed lag-k correlation magnitude of complex [N, T, F] data."""
    xm = x - x.mean(dim=1, keepdim=True)
    out = {}
    for k in lags:
        a = xm[:, :-k].reshape(-1)
        b = xm[:, k:].reshape(-1)
        out[k] = float(torch.vdot(a, b).abs() / (torch.linalg.norm(a) * torch.linalg.norm(b)))
    return out


def hankel_rank(x: torch.Tensor, window: int = 15, energy: float = 0.9999) -> float:
    """Mean effective rank (at ``energy`` cumulative) of per-sample Hankel
    matrices over 30-slot series: the per-window complexity statistic. The
    first 16 samples' matrices in one batched SVD."""
    s = min(16, x.shape[0])
    # [s, T - w + 1, F, w] -> rows (feature-major, as JAX's concatenation) x w
    windows = x[:s].unfold(1, window, 1).permute(0, 2, 1, 3)
    sv = torch.linalg.svdvals(windows.reshape(s, -1, window))
    c = torch.cumsum(sv**2, dim=-1) / torch.sum(sv**2, dim=-1, keepdim=True)
    ranks = torch.searchsorted(c, torch.full((s, 1), energy, dtype=c.dtype, device=c.device))
    return float((ranks.double() + 1).mean())


def normalized(h: torch.Tensor) -> torch.Tensor:
    """Packed ri channels ``[N, T, ..., 2]`` as complex ``[N, T, F]``, each
    sample scaled to unit mean power."""
    n, t = h.shape[:2]
    x = torch.complex(h[..., 0], h[..., 1]).reshape(n, t, -1)
    rms = torch.sqrt(torch.mean(x.abs() ** 2, dim=(1, 2), keepdim=True))
    return x / rms


def generate(speed_kmh: float, n: int, t: int, seed: int = 0, *, device=None,
             draws=None) -> torch.Tensor:
    """``n`` samples of ``t`` slots at the recovered slot period and
    ``speed_kmh``, from the port's generator keyed by ``seed`` (``draws``,
    one a chunk of ``min(n, 512)``, replace its draws), normalised."""
    m = CDLModel(sampling_frequency=1.0 / SLOT_PERIOD, ue_speed_ms=speed_kmh / 3.6)
    h = generate_beamformed_dataset(seed, model=m, num_samples=n, num_slots=t,
                                    batch_size=min(n, 512), device=device, draws=draws)
    return normalized(h)


def wiener_curve(x: torch.Tensor, seq: int = 90) -> dict:
    """Per-SNR ensemble Wiener (optimal linear) prediction NMSE bound."""
    n = x.shape[0]
    yobs = x[:, :seq].reshape(n, -1)
    fut = x[:, seq:].reshape(n, -1)
    cyy = yobs.conj().T @ yobs / n
    cxy = fut.conj().T @ yobs / n
    ex2 = float(torch.mean(fut.abs() ** 2)) * fut.shape[1]
    eye = torch.eye(cyy.shape[0], dtype=cyy.dtype, device=cyy.device)
    out = {}
    for snr in REF_SNR_TABLE:
        s2 = 10 ** (-snr / 10)
        w = torch.linalg.solve((cyy + s2 * eye).T, cxy.T).T
        out[snr] = float((ex2 - torch.real(torch.trace(w @ cxy.conj().T))) / ex2)
    return out


def fit_speed(speeds, n: int, *, device, seed: int = 0, log=print):
    """The speed grid's Wiener curves on ``n`` samples of 95 slots from the
    generator keyed by ``seed``, and the speed whose curve is nearest the
    table in RMS dB: ``(rows, best, best_cost)``."""
    rows = {}
    best, best_cost = None, np.inf
    for v in speeds:
        curve = wiener_curve(generate(v, n, 95, seed, device=device))
        deltas = {s: 10 * np.log10(curve[s] / REF_SNR_TABLE[s]) for s in curve}
        cost = float(np.sqrt(np.mean([d**2 for d in deltas.values()])))
        rows[str(v)] = {
            "wiener": curve,
            "delta_db": {k: round(v2, 2) for k, v2 in deltas.items()},
            "rms_delta_db": round(cost, 2),
        }
        if cost < best_cost:
            best, best_cost = v, cost
        log(f"v={v} km/h rms_delta={cost:.2f} dB {rows[str(v)]['delta_db']}")
    return rows, best, best_cost


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Calibrate the channel generator's UE speed.")
    p.add_argument("--speeds", type=str, default="2,4,5,5.5,6,8,15,30")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--out", type=str, default="weights/calibration.json")
    p.add_argument("--pickle", type=str, default=None,
                   help="the reference's MimoSimulation/channel.pickle (slot-geometry prong; "
                        "skipped without it)")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    result = {"slot_period_us": SLOT_PERIOD * 1e6, "ref_snr_table": REF_SNR_TABLE}

    # Prong 1: slot geometry vs the stored pickle.
    if args.pickle and os.path.exists(args.pickle):
        with open(args.pickle, "rb") as f:
            ref = torch.from_numpy(np.asarray(pickle.load(f)))
        refx = ref.reshape(ref.shape[0], ref.shape[1], -1)
        result["pickle_lag_curve"] = lag_curve(refx)
        result["pickle_hankel_rank"] = hankel_rank(refx)
        ours30 = generate(30.0, 64, 30, seed=1, device=device)
        result["ours_30kmh_lag_curve"] = lag_curve(ours30)
        result["ours_30kmh_hankel_rank"] = hankel_rank(ours30)

    # Prong 2: UE-speed fit against the SNR table via the Wiener bound.
    rows, best, best_cost = fit_speed([float(s) for s in args.speeds.split(",")], args.n,
                                      device=device, log=lambda msg: print(msg, flush=True))
    result["speed_grid"] = rows
    result["fitted_speed_kmh"] = best
    result["fitted_rms_delta_db"] = round(best_cost, 2)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"fitted_speed_kmh": best, "rms_delta_db": round(best_cost, 2)}))
    return result


if __name__ == "__main__":
    main()
