"""End-to-end link simulation with the channel predictor in the loop (the
counterpart of ``experiments/end_to_end_sim.py``).

Reference: ``MimoSimulation/`` (Sionna BER sim + ``Predict.py`` loading an
InformerStack checkpoint to predict 5 slots from the history),
``EndtoEndSimulation(WIP)/End2End.py`` and
``SpectralEfficiency(WIP)/NMSEvsSpectralEfficiency.py``. For a batch of
channel trajectories the predictor forecasts the next ``pred_len`` effective
channels from the noisy history; the link ZF-precodes on (a) perfect CSI,
(b) the outdated last-observed channel and (c) the prediction, and measures
BER (and BLER, coded) over an Eb/N0 sweep and the spectral efficiency.

    python -m channelestimationtransformer_torch.cli.end_to_end_sim \\
        --checkpoint weights/tmodel_<name>_50.pt --calibrated --ue-speed-kmh 5

The predictor is the flagship (``InformerConfig()``) from a
``cli.train_informer`` checkpoint; on the card it takes the bd attention
kernels (13 forward launches a run). The dataset is keyed 77 and the batch
drawn from the stream ``(78,)``. As JAX passes ``key(5)`` to every (source,
Eb/N0) call, every call here draws from a fresh generator on the stream
``(5,)``: the three sources see the same bits and noise. It writes ``--out``
with the JAX driver's keys and prints its lines (``cli.collect_e2e`` parses
them).
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..channel.cdl import add_channel_args
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import make_batch
from ..sim.link import LinkConfig, simulate_ber, simulate_coded_ber
from ..sim.precoding import precoded_spectral_efficiency
from ..train.trainer import _predict
from ._study import add_device_arg, datasets, flagship_state

SOURCES = ("perfect", "outdated", "predicted")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="End-to-end link simulation with the predictor.")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--ebno-db", type=float, nargs="+", default=[-4, -2, 0, 2, 4, 6, 8, 10])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--coded", action="store_true",
                   help="coded link; the reference's LDPC-coded Sionna sim analogue "
                        "(sim/coding.py, sim/ldpc.py)")
    p.add_argument("--fec", choices=["conv", "ldpc"], default="conv",
                   help="FEC for --coded: K=7 r=1/2 conv+Viterbi, or QC-LDPC (n=648) + "
                        "min-sum BP")
    p.add_argument("--horizon", type=int, default=4,
                   help="0-based slot of the prediction horizon to evaluate")
    p.add_argument("--csi", choices=["perfect", "ls"], default="perfect",
                   help="receiver channel knowledge: genie effective channel or pilot-based "
                        "least squares (reference perfect_csi switch, "
                        "KerasFullSimulation.py:200-231)")
    p.add_argument("--domain", choices=["freq", "time"], default="freq",
                   help="flat per-subcarrier model, or the OFDM modulate -> time channel -> "
                        "demodulate branch")
    p.add_argument("--out", default="weights/e2e_results.json")
    add_channel_args(p)
    add_device_arg(p)
    return p


def features_to_channel(x: torch.Tensor, nr: int, nt: int) -> torch.Tensor:
    """Packed features ``[..., Nr*Nt*2]`` -> real-pair channel ``[..., Nr, Nt, 2]``."""
    return x.reshape(*x.shape[:-1], nr, nt, 2)


@torch.no_grad()
def link_rows(h_true, sources, *, ebno_db, coded=False, fec="conv", csi="perfect",
              domain="freq", draws=None):
    """BER (BLER, coded) at each Eb/N0 and SE of each ``(name, h_precode)``
    of ``sources``, sent over ``h_true``; every link call draws from a fresh
    generator on the stream ``(5,)``, or takes ``draws`` (``bits`` or
    ``info``, ``noise``). Returns ``({name: {"ber", "bler", "se"}}, payload
    bits simulated)``."""
    device = h_true.device
    rows, bits_total = {}, 0
    for name, h_pre in sources:
        bers, blers = [], []
        for ebno in ebno_db:
            generator = stream_generator(device, 5)
            if coded:
                # LDPC frames are n=648: 162 QPSK symbols x 2 streams x 2 bps
                n_sym = 162 if fec == "ldpc" else 128
                ber, bler, total = simulate_coded_ber(
                    generator, h_true, h_pre, float(ebno), LinkConfig(qam_order=4), n_sym,
                    fec=fec, csi=csi, domain=domain, device=device, **(draws or {}))
                blers.append(float(bler))
            else:
                ber, total = simulate_ber(
                    generator, h_true, h_pre, float(ebno), LinkConfig(qam_order=4), 128,
                    csi=csi, domain=domain, device=device, **(draws or {}))
            bers.append(float(ber))
            bits_total += total
        se = float(torch.mean(precoded_spectral_efficiency(h_true, h_pre, 100.0)))
        rows[name] = {"ber": bers, "bler": blers, "se": se}
    return rows, bits_total


@torch.no_grad()
def link_study(model, enc_in, dec_in, target, *, ebno_db, coded=False, fec="conv",
               horizon=4, csi="perfect", domain="freq", draws=None):
    """The body of the JAX driver's ``main`` after its batch: the prediction,
    its NMSE at ``horizon``, and BER (BLER) and SE for each CSI source, with
    the driver's lines printed. ``draws`` go to every link call
    (:func:`link_rows`). Returns ``(results, payload bits simulated)``."""
    pred = _predict(model, enc_in, dec_in)
    h_true = features_to_channel(target[:, horizon], 2, 4)
    h_pred = features_to_channel(pred[:, horizon], 2, 4)
    h_outdated = features_to_channel(enc_in[:, -1], 2, 4)

    nmse = float(torch.sum(torch.square(h_true - h_pred)) / torch.sum(torch.square(h_true)))
    print(f"Prediction NMSE at horizon {horizon}: {nmse:.4f} ({10 * math.log10(nmse):.2f} dB)",
          flush=True)

    results = {"prediction_nmse": nmse, "ebno_db": list(ebno_db), "ber": {}, "se": {},
               "coded": bool(coded), "fec": fec, "csi": csi, "domain": domain}
    if coded:
        results["bler"] = {}
    rows, bits_total = link_rows(h_true, zip(SOURCES, (h_true, h_outdated, h_pred)),
                                 ebno_db=ebno_db, coded=coded, fec=fec, csi=csi, domain=domain,
                                 draws=draws)
    for name, row in rows.items():
        se, bers, blers = row["se"], row["ber"], row["bler"]
        results["ber"][name] = bers
        results["se"][name] = se
        if coded:
            results["bler"][name] = blers
            print(f"{name}: SE {se:.2f} b/s/Hz, coded BER {bers}, BLER {blers}", flush=True)
        else:
            print(f"{name}: SE {se:.2f} b/s/Hz, BER {bers}", flush=True)
    return results, bits_total


def main(argv=None) -> dict:
    """Run the simulation; returns the result written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(use_pallas=device.type == "cuda")
    state, _ = flagship_state(cfg, TrainConfig(), device, args.checkpoint)
    model = state.model.eval()
    (ds,) = datasets(args, cfg, device, (77, 1024))
    enc_in, dec_in, target = make_batch(ds, args.batch, cfg.label_len,
                                        generator=stream_generator(device, 78))
    results, _ = link_study(model, enc_in, dec_in, target, ebno_db=args.ebno_db,
                            coded=args.coded, fec=args.fec, horizon=args.horizon,
                            csi=args.csi, domain=args.domain)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"sweep": "e2e", "nmse": results["prediction_nmse"]}), flush=True)
    return results


if __name__ == "__main__":
    main()
