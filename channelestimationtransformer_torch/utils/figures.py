"""Figure generation: NMSE curves, SNR sweeps, channel visualization (JAX
counterpart ``utils/figures.py``, copied: it needs no JAX).

Reference: the per-experiment ``Figures/`` tooling —
``ComparisonLSTMvsRNNvsGRUvsTransformer/Figures/makePlots.py:8-60`` (NMSE vs
SNR / horizon from loss pickles), ``FullPrecision/Figures/parse.py`` +
plotting, ``MimoSimulation/ChannelPrediction.py`` (channel trajectory
visualization), and the training loop's per-epoch debug plot
(``FullPrecision/QuantizationAwareTraining.py:124-137``).

All figure functions take plain arrays/dicts and save PNGs; matplotlib's Agg
backend keeps them headless-safe. matplotlib is imported at the first
figure, not with this module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_nmse_vs_snr(results: Dict[str, Dict], path: str, *, db: bool = True):
    """``results[model][snr] = [per-horizon nmse]`` -> NMSE-vs-SNR figure
    (mean over horizons), one line per model (makePlots.py:26-42)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for model, sweep in results.items():
        snrs = sorted(float(s) for s in sweep)
        vals = [float(np.mean(sweep[s] if s in sweep else sweep[str(s)])) for s in snrs]
        if db:
            vals = [10 * np.log10(v) for v in vals]
        ax.plot(snrs, vals, marker="o", label=model)
    ax.set_xlabel("SNR [dB]")
    ax.set_ylabel("NMSE [dB]" if db else "NMSE")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    return path


def plot_nmse_vs_horizon(results: Dict[str, Sequence[float]], path: str, *, db: bool = True):
    """Per-horizon NMSE, one line per model (makePlots.py:44-60)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for model, split in results.items():
        vals = [10 * np.log10(v) for v in split] if db else list(split)
        ax.plot(np.arange(1, len(split) + 1), vals, marker="s", label=model)
    ax.set_xlabel("Prediction horizon [SRS slots]")
    ax.set_ylabel("NMSE [dB]" if db else "NMSE")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    return path


def plot_prediction_debug(history, prediction, target, path: str, feature: int = 0):
    """The trainer's per-epoch eyeball plot: input history + label vs output
    for one sample/feature (QuantizationAwareTraining.py:124-137)."""
    plt = _plt()
    history = np.asarray(history)
    prediction = np.asarray(prediction)
    target = np.asarray(target)
    t_hist = np.arange(history.shape[0])
    t_pred = np.arange(history.shape[0], history.shape[0] + target.shape[0])
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.plot(t_hist, history[:, feature], label="noisy history", alpha=0.7)
    ax.plot(t_pred, target[:, feature], "g-o", label="label")
    ax.plot(t_pred, prediction[:, feature], "r-x", label="prediction")
    ax.set_xlabel("SRS slot")
    ax.set_ylabel(f"feature {feature}")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    return path


def plot_channel_trajectories(h, path: str, num_series: int = 4):
    """Real part of the first beams' time series (Beamforming.m tail plot /
    ChannelPrediction.py visualization). ``h``: packed [T, F] or complex [T, ...]."""
    plt = _plt()
    h = np.asarray(h)
    if np.iscomplexobj(h):
        h = h.reshape(h.shape[0], -1).real
    fig, axes = plt.subplots(2, 2, figsize=(8, 5))
    for i, ax in enumerate(axes.flat[:num_series]):
        ax.plot(h[:, i])
        ax.set_title(f"series {i}")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    return path


def plot_loss_curves(parsed_logs: Dict[str, dict], path: str):
    """Valid-loss-vs-epoch curves from ``utils.parse_logs`` output."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for model, data in parsed_logs.items():
        if data["valid_loss"]:
            ax.semilogy(data["epochs"], data["valid_loss"], label=model[:40])
    ax.set_xlabel("epoch")
    ax.set_ylabel("valid loss")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    return path
