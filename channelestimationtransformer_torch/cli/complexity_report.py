"""Model complexity report: parameters and MACs for every model family (the
counterpart of ``experiments/complexity_report.py``).

Reference: ``ComparisonLSTMvsRNNvsGRUvsTransformer/complexityAnalysis.py:73-127``
(ptflops with custom input constructors; aten backend for transformers).
The five models of the JAX driver at their default configs, random weights
of seed 0, zero inputs of ``--batch`` rows; ``utils.complexity`` counts each
on its plain path (matmuls and convolutions by ``FlopCounterMode``, the
recurrent cells from their weights: the whole sequence, so JAX's
``sequential_steps`` has no counterpart). Writes the JAX driver's keys::

    python -m channelestimationtransformer_torch.cli.complexity_report --out weights/complexity.json
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..core.config import InformerConfig, RecurrentConfig, TransformerConfig
from ..core.runtime import resolve_device
from ..models import build_recurrent, build_transformer
from ..models.informer import build_informer
from ..utils.complexity import model_complexity
from ._study import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Parameters and MACs of the five model families.")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", default="weights/complexity.json")
    add_device_arg(p)
    return p


def report(batch: int, device) -> dict:
    """``{model: {"params", "macs_total", "macs_per_sample"}}`` for the
    InformerStack, the Transformer and the rnn, gru and lstm predictors."""
    out = {}
    icfg = InformerConfig()
    x_enc = torch.zeros(batch, icfg.seq_len, icfg.enc_in, device=device)
    x_dec = torch.zeros(batch, icfg.dec_len, icfg.dec_in, device=device)
    out["informer_stack"] = model_complexity(build_informer(icfg, device=device, seed=0),
                                             x_enc, x_dec)
    tcfg = TransformerConfig()
    t_dec = torch.zeros(batch, tcfg.dec_len, tcfg.enc_in, device=device)
    out["transformer"] = model_complexity(build_transformer(tcfg, device=device, seed=0),
                                          x_enc[..., : tcfg.enc_in], t_dec)
    for cell in ("rnn", "gru", "lstm"):
        rcfg = RecurrentConfig(cell=cell)
        x = torch.zeros(batch, icfg.seq_len, rcfg.features, device=device)
        out[cell] = model_complexity(build_recurrent(rcfg, device=device, seed=0), x)
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = report(args.batch, resolve_device(args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    for k, v in result.items():
        print(f"{k}: params={v['params']:,} MACs/sample={v['macs_per_sample']:,.0f}")
    print(json.dumps({"sweep": "complexity", "models": list(result)}))
    return result


if __name__ == "__main__":
    main()
