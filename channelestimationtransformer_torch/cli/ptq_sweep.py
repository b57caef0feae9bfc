"""Post-training quantization sweep (the counterpart of
``experiments/ptq_sweep.py``).

Reference: ``QuantizationStudy/PostTrainingQuantization/PostTrainingQuantization.py:136-274``.
It restores a ``cli.train_informer`` checkpoint of the flagship, and for
each word length ``wl`` from ``--wl-min`` to ``--wl-max`` (``fl = wl +
--fl-offset``) and each rounding (nearest, stochastic) quantizes the 72
attention and FFN weights through ``apply_weight_quant`` with one
``FixedPointWeightQuant`` (one grouped fixed-point launch on the card),
evaluates 8 batches and writes ``--out`` (``ptq_results.json``) and
``loss_list_<rounding>.pkl`` beside it, with the JAX driver's keys::

    python -m channelestimationtransformer_torch.cli.ptq_sweep --use-pallas \\
        --checkpoint weights/tmodel_<name>_50.pt --calibrated --ue-speed-kmh 5

Every row is evaluated on the same draws (batch ``i`` from the stream
``(7, i)``, as JAX reuses ``fold_in(key(7), i)``); stochastic rounding at
``wl`` draws from a generator seeded ``wl`` (JAX: ``key(wl)``). The
pickles list the rows in ``sorted()`` order of their keys, so ``wl10``-
``wl15`` come before ``wl4``-``wl9``, as the JAX driver writes them.
``--device`` and ``--use-pallas`` go beyond the JAX driver.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle

import torch

from ..channel.cdl import add_channel_args
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device
from ..ops.quant import FixedPointWeightQuant, apply_weight_quant, build_weight_quant_settings
from ._study import add_port_args, datasets, flagship_state, validate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Post-training quantization sweep.")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--snr", type=float, default=21.0)
    p.add_argument("--wl-min", type=int, default=4)
    p.add_argument("--wl-max", type=int, default=15)
    p.add_argument("--fl-offset", type=int, default=-4,
                   help="fractional length = wl + offset. The reference uses "
                        "-4 in the PTQ sweep (PostTrainingQuantization.py:146) "
                        "but -1 in its eval-only variant (Eval.py:196, SURVEY "
                        "quirk 9)")
    p.add_argument("--val-samples", type=int, default=2048)
    add_channel_args(p)
    p.add_argument("--out", default="weights/ptq_results.json")
    add_port_args(p)
    return p


def main(argv=None) -> dict:
    """Run the sweep; returns the results written to ``--out``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = InformerConfig(use_pallas=args.use_pallas)
    tc = TrainConfig()
    state, epoch = flagship_state(cfg, tc, device, args.checkpoint)
    print(f"Loaded checkpoint (epoch {epoch})", flush=True)
    (val_ds,) = datasets(args, cfg, device, (123, args.val_samples))

    def run(model):
        return validate(model, val_ds, batch_size=tc.batch_size, label_len=cfg.label_len,
                        num_batches=8, stream=(7,))

    model = state.model
    results = {"fp32": run(model)}
    print("fp32:", results["fp32"], flush=True)
    fp32 = model.state_dict()
    qmodel = copy.deepcopy(model)
    for rounding in ("nearest", "stochastic"):
        for wl in range(args.wl_min, args.wl_max + 1):
            fl = wl + args.fl_offset
            settings = build_weight_quant_settings(fp32, FixedPointWeightQuant(wl, fl, rounding))
            qmodel.load_state_dict(apply_weight_quant(
                fp32, settings, generator=torch.Generator(device=device).manual_seed(wl)))
            split, nm = run(qmodel)
            results[f"{rounding}_wl{wl}_fl{fl}"] = (split, nm)
            print(f"{rounding} wl={wl} fl={fl}: nmse={nm:.4f}", flush=True)

    folder = os.path.dirname(args.out)
    os.makedirs(folder or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    # Reference-format per-rounding loss pickles (loss_list_<rounding>.pkl,
    # PostTrainingQuantization.py tail), in sorted() order of the keys.
    for rounding in ("nearest", "stochastic"):
        loss_list = [results[k][0] for k in sorted(results) if k.startswith(rounding + "_")]
        with open(os.path.join(folder, f"loss_list_{rounding}.pkl"), "wb") as f:
            pickle.dump(loss_list, f)
    print(json.dumps({"sweep": "ptq", "entries": len(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
