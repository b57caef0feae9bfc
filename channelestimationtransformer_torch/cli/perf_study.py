"""On-card performance study (the counterpart of ``experiments/perf_study.py``,
flag for flag): the attention kernels against the plain path, the
fixed-point kernel against its plain version, and the training step in
float32 and bfloat16 with and without the bd kernels.

- ``attention_ab``: at ``ATTN_SHAPES`` (the flagship's 8 heads x 16), the
  plain ``full_attention`` (JAX's XLA path: ``ms_xla``), the mha kernel
  (JAX's Pallas ``mha_attention``: ``ms_pallas``) and, where it takes the
  shape, the bd kernel (``ms_bd``), each against the plain output; then
  forward + backward (the gradient in q of the output's sum) at the
  flagship shape on the plain path and on the bd kernels.
- ``quant_ab``: the fixed-point kernel against its plain version (wl 8, fl
  4) at 2^20 and 2^24 elements.
- ``train_step``: ``train_chunk`` of the flagship at batch 256 per
  variant (``float32``, ``bfloat16``, ``+bd`` for the kernels, ``+rbg``).

Each row names the route it timed (``route``: plain, mha, bd, or the
quant kernel). JAX's ``_scanned`` (n calls in one XLA program) becomes
CUDA-graph replay of ``inner`` calls (``utils/profiling.time_fn_amortized``);
the training step is timed by the host clock to a synchronise over whole
chunks, as JAX's. ``+rbg`` names JAX's TPU key implementation, which has no
torch counterpart (the port's streams are ``torch.Generator``\\ s): such a
variant runs as its base, and its row says so (``runs_as``). ``--steps``
(default JAX's 10) sets the steps a chunk::

    python -m channelestimationtransformer_torch.cli.perf_study --out weights/perf_study.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset
from ..models.attention import full_attention
from ..models.informer import build_informer
from ..ops.cuda.bd_attention import bd_attention, supported_shape
from ..ops.cuda.mha_attention import mha_attention
from ..ops.cuda.quant import fixed_point_quantize_reference, fused_fixed_point_quantize
from ..train.trainer import create_train_state, train_chunk
from ..utils.profiling import time_fn_amortized
from ._study import add_device_arg

ATTN_SHAPES = [(256, 90), (256, 128), (64, 512), (32, 1024)]
GRAD_SHAPE = (256, 90)
HEADS, HEAD_DIM = 8, 16  # flagship: 8 heads x 16 head-dim (d_model 128)
QUANT_SIZES = (1 << 20, 1 << 24)
INNER = 20  # calls a replayed graph
VARIANTS = ("float32", "bfloat16", "float32+bd", "bfloat16+bd", "float32+bd+rbg",
            "bfloat16+bd+rbg")
# The training rows' model and data: the flagship at batch 256 on a
# 2,048 x 100 x 16 normal dataset (JAX's).
MODEL_KWARGS: dict = {}
BATCH, SAMPLES = 256, 2048
A100_SAMPLES_PER_S = 3370.0  # BASELINE.md


def variant_config(variant: str, **model_kwargs):
    """``(InformerConfig, base variant)`` of a name such as
    ``bfloat16+bd+rbg``: the dtype first, ``bd`` for the kernels; ``rbg``
    is dropped from the base (no torch counterpart)."""
    tokens = variant.split("+")
    cfg = InformerConfig(**model_kwargs, dtype=tokens[0], use_pallas="bd" in tokens)
    return cfg, "+".join(t for t in tokens if t != "rbg")


def train_setup(variant: str, device):
    """A variant's model, train state and dataset (seed-0 weights, seeded
    normal data, SNR 21): ``(cfg, state, dataset, base variant)``."""
    cfg, base = variant_config(variant, **MODEL_KWARGS)
    h = np.random.default_rng(1).normal(size=(SAMPLES, 100, cfg.enc_in))
    ds = WindowDataset(h=torch.as_tensor(h, dtype=torch.float32, device=device),
                       seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=21.0, device=device)
    state = create_train_state(build_informer(cfg, device=device, seed=0),
                               TrainConfig(batch_size=BATCH))
    return cfg, state, ds, base


def run_chunk(cfg, state, ds, key, i, *, steps: int) -> float:
    """One chunk of ``steps`` training steps of ``BATCH`` from stream
    ``(key, i)``; its loss sum, fetched (the synchronise)."""
    m = train_chunk(state, ds, num_steps=steps, batch_size=BATCH,
                    label_len=cfg.label_len, generator=stream_generator(ds.device, key, i))
    return float(m["loss_sum"])


def _rand(rng, shape, device):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=device)


def _ms(fn, *args, reps: int) -> float:
    return time_fn_amortized(fn, *args, inner=INNER, warmup=2, reps=max(reps // 10, 3))[0]


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def attention_ab(reps: int, device):
    rng = np.random.default_rng(0)
    results = []
    plain = lambda q, k, v: full_attention(q, k, v, mask_flag=False)[0]  # noqa: E731
    mha = lambda q, k, v: mha_attention(q, k, v, causal=False)  # noqa: E731
    bd = lambda q, k, v: bd_attention(q, k, v)  # noqa: E731
    for b, l in ATTN_SHAPES:
        q, k, v = (_rand(rng, (b, l, HEADS, HEAD_DIM), device) for _ in range(3))
        ref = plain(q, k, v)
        ms_plain, ms_mha = _ms(plain, q, k, v, reps=reps), _ms(mha, q, k, v, reps=reps)
        row = {"bench": "attention_ab", "batch": b, "seq": l, "ms_xla": round(ms_plain, 4),
               "ms_pallas": round(ms_mha, 4), "speedup": round(ms_plain / ms_mha, 3),
               "max_abs_err": _max_err(ref, mha(q, k, v)),
               "route": {"ms_xla": "plain", "ms_pallas": "mha"}}
        if supported_shape(q, k, v):
            ms_bd = _ms(bd, q, k, v, reps=reps)
            row.update(ms_bd=round(ms_bd, 4), speedup_bd=round(ms_plain / ms_bd, 3),
                       max_abs_err_bd=_max_err(ref, bd(q, k, v)))
            row["route"]["ms_bd"] = "bd"
        print(json.dumps(row), flush=True)
        results.append(row)
    # Forward + backward at the flagship shape: the plain path's autograd
    # against the bd forward and backward kernels.
    b, l = GRAD_SHAPE
    q, k, v = (_rand(rng, (b, l, HEADS, HEAD_DIM), device) for _ in range(3))
    for impl, route, one in (("xla", "plain", plain), ("bd", "bd", bd)):
        def grad_one(q, k, v, one=one):
            leaf = q.detach().requires_grad_()
            return torch.autograd.grad(one(leaf, k, v).sum(), leaf)[0]
        row = {"bench": "attention_grad_ab", "batch": b, "seq": l, "impl": impl,
               "ms": round(_ms(grad_one, q, k, v, reps=reps), 4), "route": route}
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


def quant_kernel_ab(reps: int, device):
    """The fixed-point kernel against its plain version at the optimizer's
    weight-quantization scale (the flagship's parameters ~1 M elements)."""
    rng = np.random.default_rng(2)
    results = []
    plain = lambda x: fixed_point_quantize_reference(x, 8, 4)  # noqa: E731
    kernel = lambda x: fused_fixed_point_quantize(x, 8, 4)  # noqa: E731
    for n in QUANT_SIZES:
        x = _rand(rng, (n,), device) * 0.1
        ms_plain, ms_kernel = _ms(plain, x, reps=reps), _ms(kernel, x, reps=reps)
        row = {"bench": "quant_ab", "elements": n, "ms_xla": round(ms_plain, 4),
               "ms_pallas": round(ms_kernel, 4), "speedup": round(ms_plain / ms_kernel, 3),
               "max_abs_err": _max_err(plain(x), kernel(x)),
               "route": {"ms_xla": "plain", "ms_pallas": "fixed_point_quantize kernel"}}
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


def train_step_dtype_ab(reps: int, device, steps: int):
    results = []
    for variant in VARIANTS:
        try:
            cfg, state, ds, base = train_setup(variant, device)
            for i in range(2):  # warm-up: the kernels build, the allocator settles
                run_chunk(cfg, state, ds, 2, i, steps=steps)
            n_chunks = max(reps // 10, 3)
            t0 = time.perf_counter()
            for i in range(n_chunks):
                run_chunk(cfg, state, ds, 2, 10 + i, steps=steps)
            ms = (time.perf_counter() - t0) * 1000 / n_chunks
            samples_s = BATCH * steps / (ms / 1000)
            row = {"bench": "train_step", "dtype": variant, "ms_per_batch": round(ms / steps, 4),
                   "samples_per_s": round(samples_s, 1),
                   "vs_a100_baseline": round(samples_s / A100_SAMPLES_PER_S, 2),
                   "route": "bd" if cfg.use_pallas else "plain"}
            if base != variant:
                row["runs_as"] = base
            print(json.dumps(row), flush=True)
            results.append(row)
        except RuntimeError as exc:
            print(json.dumps({"bench": "train_step", "dtype": variant,
                              "error": str(exc)[:200]}), flush=True)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Kernel and training-step A/B on the card.")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--out", default="weights/perf_study.json")
    p.add_argument("--only", nargs="*", default=None,
                   help="subset of sections (attention_ab/quant_ab/train_step)")
    p.add_argument("--steps", type=int, default=10, help="training steps a chunk")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Device: {name}", flush=True)
    sections = {
        "attention_ab": lambda: attention_ab(args.reps, device),
        "quant_ab": lambda: quant_kernel_ab(args.reps, device),
        "train_step": lambda: train_step_dtype_ab(args.reps, device, args.steps),
    }
    # --only merges fresh sections over the existing file instead of
    # dropping the others.
    out = {}
    if args.only and os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for section, fn in sections.items():
        if args.only is None or section in args.only:
            out[section] = fn()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"sweep": "perf_study", "done": True}))
    return out


if __name__ == "__main__":
    main()
