"""Render the reference figure set from experiment outputs (the
counterpart of ``experiments/make_figures.py``).

Reference: ``PaperFigures/`` + per-experiment ``Figures/`` tooling (NMSE-vs-SNR
and NMSE-vs-horizon from loss pickles, LSQ NMSE-vs-bits, loss curves from
parsed logs). Consumes the port's drivers' JSON and log outputs in
``--weights-dir`` (the same files and keys as the JAX drivers'), and the
ProbSparse crossover artifact ``experiments/artifacts/prob_crossover.json``
where it exists (relative to the working directory, as in JAX; a JAX
measurement on a TPU v5e, titled so). Host-only: NumPy and matplotlib (Agg),
no device::

    python -m channelestimationtransformer_torch.cli.make_figures --weights-dir weights \
        --logs weights/train.log --out figures
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..models.attention import DENSE_SCORES_MAX_LK
from ..utils.figures import plot_loss_curves, plot_nmse_vs_horizon, plot_nmse_vs_snr
from ..utils.parse_logs import parse_log_text


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The reference figure set from result files.")
    p.add_argument("--weights-dir", default="weights")
    p.add_argument("--logs", nargs="*", default=[])
    p.add_argument("--out", default="figures")
    return p


def main(argv=None) -> list:
    """Write every figure whose inputs exist; returns their paths."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    made = []

    # NMSE vs SNR from fine-tune results (result_*.json).
    snr_results = {}
    for path in glob.glob(os.path.join(args.weights_dir, "result_*.json")):
        with open(path) as f:
            r = json.load(f)
        snr_results.setdefault("informer", {})[float(r["snr"])] = r["final_val_split"]
    # Comparison suite results, if present.
    comp = os.path.join(args.weights_dir, "comparison", "comparison.json")
    if os.path.exists(comp):
        with open(comp) as f:
            for model, sweep in json.load(f).items():
                snr_results[model] = {float(k): v for k, v in sweep.items()}
    if snr_results:
        made.append(plot_nmse_vs_snr(
            snr_results, os.path.join(args.out, "nmse_vs_snr.png")))
        horizon = {
            m: sweep[max(sweep)] for m, sweep in snr_results.items()
        }
        made.append(plot_nmse_vs_horizon(
            horizon, os.path.join(args.out, "nmse_vs_horizon.png")))

    # LSQ NMSE-vs-bits (PaperFigures/LSQ equivalent).
    for name in ("lsq_results.json", "lsq_fibbinary_results.json"):
        path = os.path.join(args.weights_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            rows_ = sorted(data.values(), key=lambda v: v["nbits"])
            bits = [v["nbits"] for v in rows_]
            nmse = [10 * np.log10(v["final_val_nmse"]) for v in rows_]
            fig, ax = plt.subplots(figsize=(5, 3.5))
            ax.plot(bits, nmse, "s-")
            ax.set_xlabel("weight bits")
            ax.set_ylabel("NMSE [dB]")
            ax.grid(True, alpha=0.3)
            fig.tight_layout()
            out = os.path.join(args.out, name.replace(".json", ".png"))
            fig.savefig(out, dpi=150)
            made.append(out)

    # Combined LSQ vs LSQ-fibbinary NMSE-vs-bits (the thesis's multiplier-free
    # story lives below 8 bits — the sub-8 extension makes the comparison).
    paths = {n: os.path.join(args.weights_dir, f"{n}.json")
             for n in ("lsq_results", "lsq_fibbinary_results")}
    if all(os.path.exists(p) for p in paths.values()):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5.5, 3.5))
        for (label, path), style in zip(paths.items(), ("o-", "s--")):
            with open(path) as f:
                data = json.load(f)
            rows_ = sorted(data.values(), key=lambda v: v["nbits"])
            ax.plot([v["nbits"] for v in rows_],
                    [10 * np.log10(v["final_val_nmse"]) for v in rows_],
                    style, label=label.replace("_results", ""))
        ax.set_xlabel("weight bits")
        ax.set_ylabel("val NMSE [dB]")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)
        ax.set_title("LSQ vs LSQ-fibbinary (codebook = no adjacent ones)",
                     fontsize=9)
        fig.tight_layout()
        out = os.path.join(args.out, "lsq_vs_fibbinary.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # PTQ NMSE-vs-wordlength (QuantizationStudy/PTQ loss_list figure).
    ptq = os.path.join(args.weights_dir, "ptq_results.json")
    if os.path.exists(ptq):
        with open(ptq) as f:
            data = json.load(f)
        # schema: {"fp32": [split, nmse], "<rounding>_wl<w>_fl<f>": [split, nmse]}
        series = {}
        for key, val in data.items():
            if "_wl" not in key:
                continue
            rounding, rest = key.split("_wl")
            wl = int(rest.split("_")[0])
            nmse = val[1] if isinstance(val, (list, tuple)) else val
            series.setdefault(rounding, {})[wl] = nmse
        fig, ax = plt.subplots(figsize=(5, 3.5))
        for rounding, sweep in sorted(series.items()):
            wls = sorted(sweep)
            ax.plot(wls, [10 * np.log10(sweep[w]) for w in wls], "o-",
                    label=rounding)
        if "fp32" in data:
            fp = data["fp32"][1]
            ax.axhline(10 * np.log10(fp), color="k", ls=":", label="fp32")
        ax.set_xlabel("word length [bits]")
        ax.set_ylabel("NMSE [dB]")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        out = os.path.join(args.out, "ptq_nmse_vs_wl.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # End-to-end BER vs Eb/N0 per CSI source (MimoSimulation figure).
    e2e = os.path.join(args.weights_dir, "e2e_results.json")
    if os.path.exists(e2e):
        with open(e2e) as f:
            data = json.load(f)
        fig, ax = plt.subplots(figsize=(5, 3.5))
        for name, bers in data.get("ber", {}).items():
            ax.semilogy(data["ebno_db"], np.maximum(bers, 1e-6), "o-", label=name)
        ax.set_xlabel("Eb/N0 [dB]")
        ax.set_ylabel("BER")
        ax.legend()
        ax.grid(True, which="both", alpha=0.3)
        fig.tight_layout()
        out = os.path.join(args.out, "e2e_ber.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # Model NMSE vs the AR-oracle predictability bound.
    orc = os.path.join(args.weights_dir, "ar_oracle.json")
    if os.path.exists(orc) and snr_results.get("informer"):
        with open(orc) as f:
            oracle = json.load(f)["snr"]
        snrs = sorted(snr_results["informer"])
        model_db = [
            10 * np.log10(np.mean(snr_results["informer"][s])) for s in snrs
        ]
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(snrs, model_db, "o-", label="Informer (ours)")
        osnrs = sorted(float(k) for k in oracle)
        ax.plot(osnrs, [oracle[f"{s:g}" if f"{s:g}" in oracle else str(s)]["nmse_db"]
                        for s in osnrs],
                "s--", label="AR(30) per-window oracle")
        ax.set_xlabel("SNR [dB]")
        ax.set_ylabel("NMSE [dB]")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        out = os.path.join(args.out, "nmse_vs_oracle.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # QAT progressive-quantization curves: fraction vs NMSE per schedule x
    # codebook (reference PaperFigures/QAT/plotStepsizeStrategies.py).
    qat_files = sorted(glob.glob(os.path.join(args.weights_dir, "qat_*.json")))
    if qat_files:
        fig, ax = plt.subplots(figsize=(5.5, 3.5))
        for path in qat_files:
            with open(path) as f:
                curve = json.load(f)
            if isinstance(curve, dict):  # log-recovered artifacts wrap the
                curve = curve["curve"]   # rows with provenance fields
            label = os.path.basename(path)[len("qat_"):-len(".json")]
            fr = [row["fraction"] for row in curve]
            nm = [10 * np.log10(row["val_nmse"]) for row in curve]
            ax.plot(fr, nm, "o-", ms=3, label=label)
        ax.set_xlabel("quantized weight fraction")
        ax.set_ylabel("NMSE [dB]")
        ax.legend(fontsize=6)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        out = os.path.join(args.out, "qat_fraction_curves.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # Parity vs reference: ours / reference / Wiener-oracle SNR curves.
    snr_tab = os.path.join(args.weights_dir, "snr_table.json")
    if os.path.exists(snr_tab):
        with open(snr_tab) as f:
            tab = json.load(f)
        snrs = sorted(int(k) for k in tab if tab[k].get("ref"))
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(snrs, [10 * np.log10(tab[str(s)]["split_mean"]) for s in snrs],
                "o-", label="ours (50 ep from scratch)")
        ax.plot(snrs, [10 * np.log10(tab[str(s)]["ref"]) for s in snrs],
                "s--", label="reference (A100 logs)")
        ax.set_xlabel("train/val SNR [dB]")
        ax.set_ylabel("val NMSE [dB]")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        out = os.path.join(args.out, "parity_snr.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # Round-3: scale demo (throughput + MXU fraction vs model size).
    sd = os.path.join(args.weights_dir, "scale_demo.json")
    if os.path.exists(sd):
        with open(sd) as f:
            rows = [r for r in json.load(f) if "error" not in r]
        if rows:
            names = [r["config"] for r in rows]
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3.2))
            ax1.bar(names, [r["samples_per_s"] for r in rows], width=0.6)
            ax1.set_ylabel("train samples/s (1 chip)")
            ax1.set_yscale("log")
            ax1.grid(True, axis="y", alpha=0.3)
            ax2.bar(names, [100 * r["mxu_fraction"] for r in rows], width=0.6)
            ax2.set_ylabel("MXU utilization [%]")
            ax2.grid(True, axis="y", alpha=0.3)
            for ax in (ax1, ax2):
                ax.tick_params(axis="x", rotation=20)
            fig.suptitle("fused train step vs model size (bf16)", fontsize=10)
            fig.tight_layout()
            out = os.path.join(args.out, "scale_demo.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Round-3: int8 serving accuracy/latency summary.
    i8 = os.path.join(args.weights_dir, "int8_serving.json")
    if os.path.exists(i8):
        with open(i8) as f:
            r = json.load(f)
        if "split_f32" in r:
            horizons = list(range(1, len(r["split_f32"]) + 1))
            fig, ax = plt.subplots(figsize=(5, 3.2))
            ax.plot(horizons, [10 * np.log10(v) for v in r["split_f32"]],
                    "o-", label="float32")
            ax.plot(horizons, [10 * np.log10(v) for v in r["split_int8"]],
                    "s--", label=f"int8 served (W8A8, {r['layers']} layers)")
            ax.set_xlabel("prediction horizon [slots]")
            ax.set_ylabel("val NMSE [dB]")
            ax.set_xticks(horizons)
            ax.legend()
            ax.grid(True, alpha=0.3)
            ax.set_title(
                f"int8 serving: Δ{r['nmse_delta_db']:+.2f} dB, "
                f"latency ×{r.get('latency_speedup', float('nan')):.2f}",
                fontsize=9,
            )
            fig.tight_layout()
            out = os.path.join(args.out, "int8_serving.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Per-cluster parity: seq_len sweep vs reference with the cluster's own
    # bounds (round-4 fast-cluster closure; DESIGN.md §13).
    par = os.path.join(args.weights_dir, "parity.json")
    if os.path.exists(par):
        with open(par) as f:
            sweeps = json.load(f).get("sweeps", {})
        blk = sweeps.get("seq_len", {})
        rows = blk.get("rows", {})
        if rows:
            sls = sorted(int(k) for k in rows)
            def _col(key):
                return [rows[str(s)].get(key) for s in sls]
            fig, ax = plt.subplots(figsize=(5, 3.5))
            ax.plot(sls, [10 * np.log10(v) for v in _col("split_mean")],
                    "o-", label="ours (100 ep)")
            ax.plot(sls, [10 * np.log10(v) for v in _col("ref")],
                    "s-", label="reference (A100 logs)")
            wb = _col("wiener")
            if all(v is not None for v in wb):
                ax.plot(sls, [10 * np.log10(v) for v in wb], "k--",
                        label="ensemble Wiener bound")
            ob = _col("oracle")
            if all(v is not None for v in ob):
                ax.plot(sls, [10 * np.log10(v) for v in ob], ":",
                        color="gray", label="AR(30) rollout")
            ax.set_xlabel("sequence length [slots]")
            ax.set_ylabel("val NMSE [dB]")
            ax.set_xticks(sls)
            ax.legend(fontsize=8)
            ax.grid(True, alpha=0.3)
            ax.set_title("fast cluster (30 km/h at recovered slot geometry)",
                         fontsize=9)
            fig.tight_layout()
            out = os.path.join(args.out, "seq_len_parity.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Round-4: all-axes parity delta overview (one bar per reference row,
    # grouped by sweep axis, each read against its own cluster calibration).
    if os.path.exists(par):
        with open(par) as f:
            pj = json.load(f)
        bars = []  # (label, delta_db, axis, ci_lo_hi)
        for axis, block in pj.get("sweeps", {}).items():
            spec = block.get("cluster", {}) or {}
            tag = (f"{spec['speed']:g}km/h" if spec.get("cal")
                   else f"ss{spec.get('ss')}" if spec else "?")
            for val, row in sorted(block.get("rows", {}).items(),
                                   key=lambda kv: (len(kv[0]), kv[0])):
                if row.get("delta_db") is not None:
                    ci = (row.get("ci") or {}).get("delta_db_ci95")
                    bars.append((f"{axis}={val} [{tag}]",
                                 row["delta_db"], axis, ci))
        anch = (pj.get("lsq_fp32_anchor") or {}).get("row")
        if anch and anch.get("delta_db") is not None:
            bars.append(("lsq_fp32_anchor [ss30]", anch["delta_db"], "lsq",
                         None))
        if bars:
            fig, ax = plt.subplots(figsize=(6.5, 0.28 * len(bars) + 1.2))
            ypos = range(len(bars))
            colors = ["#2a7" if d <= 0 else "#c44" for _, d, *_ in bars]
            ax.barh(ypos, [d for _, d, *_ in bars], color=colors, height=0.65)
            # 95% bootstrap CI whiskers (64-batch re-eval, eval_parity_ci.py)
            for y, (_, d, _, ci) in zip(ypos, bars):
                if ci:
                    ax.plot(ci, [y, y], color="k", lw=1.2)
                    ax.plot([ci[0]] * 2, [y - 0.18, y + 0.18], color="k", lw=1.2)
                    ax.plot([ci[1]] * 2, [y - 0.18, y + 0.18], color="k", lw=1.2)
            ax.set_yticks(list(ypos))
            ax.set_yticklabels([b[0] for b in bars], fontsize=7)
            ax.invert_yaxis()
            ax.axvline(0, color="k", lw=0.8)
            ax.set_xlabel("delta vs reference [dB]  (negative = ours better)")
            ax.grid(True, axis="x", alpha=0.3)
            ax.set_title("per-row parity vs reference, each at its own "
                         "cluster calibration", fontsize=9)
            fig.tight_layout()
            out = os.path.join(args.out, "parity_deltas.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Coded link: conv vs QC-LDPC BER/BLER at matched rate 1/2 (the
    # reference's FEC is 5G LDPC; KerasFullSimulation.py:139-151).
    conv_p = os.path.join(args.weights_dir, "e2e_coded_conv.json")
    ldpc_p = os.path.join(args.weights_dir, "e2e_coded_ldpc.json")
    if os.path.exists(conv_p) and os.path.exists(ldpc_p):
        with open(conv_p) as f:
            conv = json.load(f)
        with open(ldpc_p) as f:
            ldpc = json.load(f)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3.2))
        for data, fec, style in ((conv, "conv K=7", "o-"),
                                 (ldpc, "QC-LDPC n=648", "s--")):
            for src in ("perfect", "predicted"):
                if src in data.get("ber", {}):
                    ax1.semilogy(data["ebno_db"],
                                 np.maximum(data["ber"][src], 1e-6),
                                 style, label=f"{fec} / {src}", ms=4)
                if src in data.get("bler", {}):
                    ax2.semilogy(data["ebno_db"],
                                 np.maximum(data["bler"][src], 1e-6),
                                 style, label=f"{fec} / {src}", ms=4)
        for ax, ylab in ((ax1, "coded BER"), (ax2, "BLER")):
            ax.set_xlabel("Eb/N0 [dB]")
            ax.set_ylabel(ylab)
            ax.legend(fontsize=7)
            ax.grid(True, which="both", alpha=0.3)
        fig.suptitle("coded link: conv vs LDPC, rate 1/2 QPSK", fontsize=10)
        fig.tight_layout()
        out = os.path.join(args.out, "coded_conv_vs_ldpc.png")
        fig.savefig(out, dpi=150)
        made.append(out)

    # Round-4: flagship step-time breakdown (VERDICT r3 §6 roofline evidence).
    sp = os.path.join(args.weights_dir, "step_profile.json")
    if os.path.exists(sp):
        with open(sp) as f:
            prof = json.load(f)
        rows = {k: v for k, v in prof.get("rows", {}).items()
                if "ms_per_step" in v}
        if rows:
            order = [k for k in (
                "baseline_f32_xla", "canonical_bf16_bd_rbg",
                "canonical_fuse_qkv", "prob_f32_xla", "prob_bf16_rbg",
                "fwd_only_canonical", "fwd_only_prob", "no_distil",
                "no_dropout", "single_stack", "batch_512", "batch_1024",
                "batch_1024_fuse") if k in rows]
            fig, ax = plt.subplots(figsize=(6.5, 3.6))
            vals = [rows[k]["ms_per_step"] for k in order]
            ax.barh(range(len(order)), vals, height=0.6)
            ax.set_yticks(range(len(order)))
            ax.set_yticklabels(order, fontsize=7)
            ax.invert_yaxis()
            ax.set_xlabel("ms / train step (batch 256 unless noted)")
            for i, v in enumerate(vals):
                ax.text(v, i, f" {v:.1f}", va="center", fontsize=7)
            note = prof.get("batch_scaling_note")
            if note:
                ax.set_title(note, fontsize=8)
            ax.grid(True, axis="x", alpha=0.3)
            fig.tight_layout()
            out = os.path.join(args.out, "step_profile.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Round-4: int8 serving latency at production sizes.
    i8s = os.path.join(args.weights_dir, "int8_scale_ab.json")
    if os.path.exists(i8s):
        with open(i8s) as f:
            rows = [r for r in json.load(f) if "error" not in r]
        if rows:
            names = [r["config"] for r in rows]
            x = np.arange(len(rows))
            fig, ax = plt.subplots(figsize=(6, 3.4))
            variants = [("float32", "f32"), ("bfloat16", "bf16"),
                        ("int8", "W8A8 int8")]
            if any("ms_int8_wo" in r for r in rows):
                variants.append(("int8_wo", "weight-only int8 (bf16 MACs)"))
            w = 0.8 / len(variants)
            for i, (variant, label) in enumerate(variants):
                ax.bar(x + (i - (len(variants) - 1) / 2) * w,
                       [r.get(f"ms_{variant}", float("nan")) for r in rows],
                       width=w, label=label)
            for xi, r in zip(x, rows):
                key = ("int8_wo_speedup_vs_bf16" if "ms_int8_wo" in r
                       else "int8_speedup_vs_f32")
                ref_ms = r.get("ms_int8_wo", r["ms_int8"])
                if r.get(key):
                    ax.text(xi + 0.3, ref_ms, f" ×{r[key]:.2f} vs bf16",
                            ha="center", va="bottom", fontsize=6, rotation=90)
            ax.set_xticks(x)
            ax.set_xticklabels(
                [f"{n}\n(dm{r['d_model']})" for n, r in zip(names, rows)],
                fontsize=8)
            ax.set_ylabel("inference ms / forward")
            ax.set_yscale("log")
            ax.legend(fontsize=8)
            ax.grid(True, axis="y", which="both", alpha=0.3)
            ax.set_title("int8 serving vs model size (W8A8 + weight-only)",
                         fontsize=9)
            fig.tight_layout()
            out = os.path.join(args.out, "int8_scale_ab.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Round-5: ProbSparse layout crossover (dense-select vs key-gather).
    xo = os.path.join("experiments", "artifacts", "prob_crossover.json")
    if os.path.exists(xo):
        with open(xo) as f:
            rows = [r for r in json.load(f).get("rows", [])
                    if r.get("ms_dense_select") and r.get("ms_key_gather")]
        if rows:
            ls = [r["l"] for r in rows]
            fig, ax = plt.subplots(figsize=(5.5, 3.5))
            ax.plot(ls, [r["ms_dense_select"] for r in rows], "o-",
                    label="dense-select (one-hot einsums)")
            ax.plot(ls, [r["ms_key_gather"] for r in rows], "s-",
                    label="key-gather")
            ax.axvline(DENSE_SCORES_MAX_LK, color="k", ls=":",
                       label=f"threshold ({DENSE_SCORES_MAX_LK})")
            ax.set_xscale("log", base=2)
            ax.set_yscale("log")
            ax.set_xlabel("sequence length l (batch scaled as ~24k/l)")
            ax.set_ylabel("fwd+bwd ms / call")
            ax.legend(fontsize=8)
            ax.grid(True, which="both", alpha=0.3)
            ax.set_title("ProbSparse layout crossover (TPU v5e)", fontsize=9)
            fig.tight_layout()
            out = os.path.join(args.out, "prob_crossover.png")
            fig.savefig(out, dpi=150)
            made.append(out)

    # Loss curves from any text logs given.
    parsed = {}
    for logpath in args.logs:
        with open(logpath) as f:
            parsed.update(parse_log_text(f.read()))
    if parsed:
        made.append(plot_loss_curves(parsed, os.path.join(args.out, "loss_curves.png")))

    print(json.dumps({"figures": made}))
    return made


if __name__ == "__main__":
    main()
