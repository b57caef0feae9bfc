"""Drive the PyTorch port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py            # the check, as run on the card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of eval and training

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and convs;
2. build: the three CUDA kernel libraries, compiled in parallel with nvcc
   from the sources here;
3. kernel, eval: the bd-attention forward kernel (dropout 0) against its
   plain version at the six flagship shape classes in float32 and bfloat16,
   with kernel, plain and ``F.scaled_dot_product_attention`` (yardstick
   only) times;
4. kernel, xl eval: the mha-attention forward kernel against its plain
   version at the six shape classes of the xl model (B 64, H 8, E 128) and
   two shapes beyond the model (D != E; a long non-square causal shape), in
   float32 and bfloat16, timed likewise;
5. kernel, training: at the flagship shapes in both dtypes, the forward
   kernel with dropout 0.05 and its row log-sum-exp against the plain
   version on the same seed, the kernel's dropout mask against ``dropout_keep_mask``
   (exact), and the backward kernel's dQ/dK/dV against
   ``bd_attention_bwd_reference``, each timed beside its bound and the SDPA
   yardstick;
6. eval path: ``build_informer(InformerConfig(use_pallas=True))`` at full
   width and ``eval_chunk`` over 8 batches of 256 from a 65,536-sample
   dataset resident on the card, with the kernels' launch counts (all 104
   attention calls through the bd forward kernel), NMSE, a comparison with
   the plain attention path on one batch, the model's parameters and FLOPs
   per batch, and steady-state eval samples/s and TFLOP/s;
7. xl eval path: the same at the xl width (d_model 1024, d_ff 4096, seq_len
   256; ``experiments/scale_demo.py``'s "xl" row), 8 batches of 64 from a
   4,096 x 266 x 16 dataset: all 104 attention calls through the mha
   kernel, none through the bd kernels;
8. training path: the flagship model in train mode (dropout 0.05). One step
   through the kernels and one through the plain attention path from the
   same weights, batch and generator seed (so the same dropout masks),
   compared loss, output and gradient by gradient; ``train_chunk`` with the
   kernels' launch counts and a finite loss; steady-state training
   samples/s of both paths.

The last three lines are the card's name and power limit, the kernels' JSON
record and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores
# (label, l_q, l_k, causal, calls per eval batch or training step) at B 256, H 8, E 16
SHAPES = [
    ("enc L=90", 90, 90, False, 1),
    ("enc L=45", 45, 45, False, 2),
    ("enc L=23", 23, 23, False, 2),
    ("enc L=12", 12, 12, False, 2),
    ("dec self L=15 causal", 15, 15, True, 3),
    ("cross 15x24", 15, 24, False, 3),
]
B, H, E = 256, 8, 16
# The xl model's attention calls, (label, l_q, l_k, causal, calls per eval
# batch) at B 64, H 8, E = D 128; then shapes beyond the model, (label, l_q,
# l_k, causal, 0, b, h, e, d), counted in no batch.
XL_SHAPES = [
    ("xl enc L=256", 256, 256, False, 1),
    ("xl enc L=128", 128, 128, False, 2),
    ("xl enc L=64", 64, 64, False, 2),
    ("xl enc L=32", 32, 32, False, 2),
    ("xl dec self L=15 causal", 15, 15, True, 3),
    ("xl cross 15x64", 15, 64, False, 3),
]
XL_B, XL_H, XL_E = 64, 8, 128
MHA_EXTRA_SHAPES = [
    ("E128 D64 100x333 causal", 100, 333, True, 0, 64, 8, 128, 64),
    ("E64 512x1024 causal", 512, 1024, True, 0, 16, 8, 64, 64),
]
DROPOUT = 0.05  # InformerConfig().dropout
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}  # (rtol, atol), forward
BWD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (1e-2, 1e-2)}  # longer sums in dK, dV
MAIN_TOL = (1e-3, 1e-4)  # kernel path vs plain path, whole model forward, TF32 off
# Kernel path vs plain path, one training step: each gradient's max abs
# difference over the larger of its own max abs and 1e-3 of the largest
# gradient's (the two paths round the attention sums differently, and the
# difference passes through 13 layers and the backward). The floor keeps
# gradients that are zero in exact arithmetic, such as the key biases'
# (softmax ignores a constant added to a row of scores), from being compared
# noise to noise.
GRAD_TOL = 1e-3
TRAIN_STEPS = 8
OUT = pathlib.Path("chiprun_out")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def _median_ms(torch, run, reps, per_run):
    """Median over ``reps`` CUDA-event windows around ``run()``, per call."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def time_ms(torch, fn, reps=21, inner=20):
    """Device time of one call: ``inner`` calls captured in a CUDA graph and
    timed by replay. The graph removes the host's launch cost, which eager
    calls at these sizes are bound by (see :func:`eager_ms`). Inputs stay in
    the 50 MB L2 from call to call, as on the main path, where the
    projections that make them run just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    return _median_ms(torch, graph.replay, reps, inner)


def eager_ms(torch, fn, reps=21, inner=20):
    """Time per eager call, host launch cost included."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(inner):
            fn()
    return _median_ms(torch, run, reps, inner)


def _pairs(l_q, l_k, causal):
    return sum(min(i + 1, l_k) for i in range(l_q)) if causal else l_q * l_k


def _bound(nbytes, flops, dtype):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def fwd_bound(l_q, l_k, causal, dtype, *, b, h, e, d=None, with_lse=False):
    """Least time for one forward: Q, K, V read once and O (and lse) written
    once over HBM, or the matmul FLOPs of the unmasked (row, key) pairs
    (2*(E + D) each) over the dtype's peak rate, whichever is larger. The
    dropout mask's integer work is not counted."""
    d = e if d is None else d
    size = 4 if dtype == "float32" else 2
    nbytes = (size * b * h * (e + d) * (l_q + l_k)
              + (4 * b * h * l_q if with_lse else 0))
    return _bound(nbytes, 2 * b * h * (e + d) * _pairs(l_q, l_k, causal), dtype)


def bwd_bound(l_q, l_k, causal, dtype):
    """Least time for one backward: Q, K, V, O, dO and lse read once, dQ,
    dK, dV written once; or ~10*E FLOPs per unmasked pair (QK^T and dO V^T
    recomputed, dQ, dK, dV), whichever is larger."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * B * H * E * (4 * l_q + 4 * l_k) + 4 * B * H * l_q
    return _bound(nbytes, 10 * B * H * E * _pairs(l_q, l_k, causal), dtype)


def _compare(torch, got, want, tol):
    diff = (got.float() - want.float()).abs()
    rel = (diff / want.float().abs().clamp_min(1e-3)).max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=tol[0], atol=tol[1])
    return diff.max().item(), rel, ok


def _inputs(torch, gen, dtype, l_q, l_k, *, b=B, h=H, e=E, d=None):
    return tuple(torch.randn(b, l, h, w, generator=gen, device="cuda").to(dtype)
                 for l, w in ((l_q, e), (l_k, e), (l_k, e if d is None else d)))


def phase_kernel(torch, F, kernel_fn, reference, shapes, prefix="kernel", seed=0):
    """An eval forward kernel against its plain version at ``shapes``
    ((label, l_q, l_k, causal, calls per eval batch, b, h, e, d)) in float32
    and bfloat16, with kernel, plain and ``F.scaled_dot_product_attention``
    times."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, l_q, l_k, causal, calls, b, h, e, d in shapes:
            q, k, v = _inputs(torch, gen, dtype, l_q, l_k, b=b, h=h, e=e, d=d)
            got = kernel_fn(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = reference(q.float(), k.float(), v.float(), causal=causal)
            rtol, atol = TOL[dtype_name]
            abs_err, rel_err, ok = _compare(torch, got, want.to(dtype), TOL[dtype_name])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def kernel():
                return kernel_fn(q, k, v, causal=causal)
            ms = time_ms(torch, kernel)
            kernel_eager_ms = eager_ms(torch, kernel)
            plain_ms = time_ms(torch, lambda: reference(q, k, v, causal=causal))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            row = dict(shape=label, dtype=dtype_name, b=b, h=h, e=e, d=d, l_q=l_q, l_k=l_k,
                       causal=causal, calls_per_batch=calls, max_abs_err=abs_err,
                       max_rel_err=rel_err, rtol=rtol, atol=atol, ms=ms,
                       eager_ms=kernel_eager_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       **fwd_bound(l_q, l_k, causal, dtype_name, b=b, h=h, e=e, d=d))
            rows.append(row)
            print(f"{prefix} {label:24s} {dtype_name:8s} max_abs {abs_err:.3e} max_rel "
                  f"{rel_err:.3e} (rtol {rtol}, atol {atol}) {'ok' if ok else 'MISMATCH'} | "
                  f"kernel {ms * 1e3:.1f} us (eager {kernel_eager_ms * 1e3:.1f}), plain "
                  f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']})", flush=True)
            if not ok:
                fail(f"{prefix} disagrees with its plain version at {label} {dtype_name}")
    return rows


def kernel_keep_mask(torch, ops, q, k, causal, seed):
    """The forward kernel's dropout mask, read back through one-hot values:
    with V's row j the unit vector of column j - E*g, output column c of
    pass g is P_drop[:, E*g + c], nonzero exactly where the key is kept
    (every unmasked probability is > 0 at these inputs)."""
    l_k = k.shape[1]
    kept = torch.zeros(B, H, q.shape[1], l_k, dtype=torch.bool, device="cuda")
    for g in range(0, l_k, E):
        cols = torch.arange(g, min(g + E, l_k), device="cuda")
        v = torch.zeros_like(k)
        v[:, cols, :, cols - g] = 1.0
        out = ops.bd_attention(q, k, v, causal=causal, dropout=DROPOUT, seed=seed)
        kept[..., g:g + E] = (out.permute(0, 2, 1, 3) != 0)[..., :len(cols)]
    return kept


def phase_kernel_train(torch, F, ops):
    """The training kernels at the flagship shapes: forward with dropout
    (and lse), its mask, and the backward."""
    fwd_rows, bwd_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, l_q, l_k, causal, calls in SHAPES:
            q, k, v = _inputs(torch, gen, dtype, l_q, l_k)
            do = torch.randn(B, l_q, H, E, generator=gen, device="cuda").to(dtype)
            seed = ops.draw_seed(gen, "cuda")
            scale = E ** -0.5
            kw = dict(causal=causal, scale=scale, dropout=DROPOUT)

            # Forward with dropout and lse, against the plain version on the same seed.
            o, lse = ops.bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
            torch.cuda.synchronize()
            want, want_lse = ops._reference_forward(q.float(), k.float(), v.float(), seed=seed,
                                                    with_lse=True, **kw)
            abs_err, rel_err, ok = _compare(torch, o, want.to(dtype), TOL[dtype_name])
            lse_err, _, lse_ok = _compare(torch, lse, want_lse, (1e-5, 1e-5))
            mask_ok = torch.equal(
                kernel_keep_mask(torch, ops, q, k, causal, seed),
                ops.dropout_keep_mask(seed, B, H, l_q, l_k, 1.0 - DROPOUT)
                & ~torch.ones(l_q, l_k, dtype=torch.bool, device="cuda").triu(1 if causal else l_k))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def fwd():
                return ops.bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
            row = dict(shape=label, dtype=dtype_name, l_q=l_q, l_k=l_k, causal=causal,
                       calls_per_step=calls, dropout=DROPOUT, max_abs_err=abs_err,
                       max_rel_err=rel_err, lse_max_abs_err=lse_err, mask_equal=mask_ok,
                       ms=time_ms(torch, fwd), eager_ms=eager_ms(torch, fwd),
                       plain_ms=time_ms(torch, lambda: ops._reference_forward(
                           q, k, v, seed=seed, with_lse=True, **kw)),
                       library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, dropout_p=DROPOUT, is_causal=causal)),
                       **fwd_bound(l_q, l_k, causal, dtype_name, b=B, h=H, e=E,
                                   with_lse=True))
            fwd_rows.append(row)
            print(f"train fwd {label:22s} {dtype_name:8s} dropout {DROPOUT}: max_abs "
                  f"{abs_err:.3e} lse {lse_err:.3e} {'ok' if ok and lse_ok else 'MISMATCH'}, "
                  f"mask {'equal' if mask_ok else 'DIFFERS'} | kernel {row['ms'] * 1e3:.1f} us "
                  f"(eager {row['eager_ms'] * 1e3:.1f}), plain {row['plain_ms'] * 1e3:.1f} us, "
                  f"sdpa {row['library_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us "
                  f"({row['bound_by']})", flush=True)
            if not (ok and lse_ok and mask_ok):
                fail(f"forward kernel with dropout disagrees at {label} {dtype_name}")

            # Backward, against the plain version on the same o, lse and seed.
            got = ops.bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
            torch.cuda.synchronize()
            want = ops.bd_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                                  do.float(), lse, seed, **kw)
            errs = [_compare(torch, g, w.to(dtype), BWD_TOL[dtype_name])
                    for g, w in zip(got, want)]
            ok = all(e[2] for e in errs)

            def bwd():
                return ops.bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
            dog = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qg, kg, vg, dropout_p=DROPOUT,
                                                      is_causal=causal)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dog)
            lib_ms = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd)
            row = dict(shape=label, dtype=dtype_name, l_q=l_q, l_k=l_k, causal=causal,
                       calls_per_step=calls, dropout=DROPOUT,
                       max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                       rtol=BWD_TOL[dtype_name][0], atol=BWD_TOL[dtype_name][1],
                       ms=time_ms(torch, bwd), eager_ms=eager_ms(torch, bwd),
                       plain_ms=time_ms(torch, lambda: ops.bd_attention_bwd_reference(
                           q, k, v, o, do, lse, seed, **kw)),
                       library_ms=lib_ms, **bwd_bound(l_q, l_k, causal, dtype_name))
            bwd_rows.append(row)
            print(f"train bwd {label:22s} {dtype_name:8s} dQ/dK/dV max_abs "
                  f"{' '.join(f'{e[0]:.2e}' for e in errs)} (rtol {row['rtol']}, atol "
                  f"{row['atol']}) {'ok' if ok else 'MISMATCH'} | kernel {row['ms'] * 1e3:.1f} us "
                  f"(eager {row['eager_ms'] * 1e3:.1f}), plain {row['plain_ms'] * 1e3:.1f} us, "
                  f"sdpa bwd {lib_ms * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us "
                  f"({row['bound_by']})", flush=True)
            if not ok:
                fail(f"backward kernel disagrees with its plain version at {label} {dtype_name}")
    return fwd_rows, bwd_rows


def _models_and_data(torch, cfg=None, samples=65536, slots=None):
    """The kernel-path model (seed 0), the plain-path model with the same
    weights, and a random dataset resident on the card; by default the
    flagship config on 65,536 x 100 x 16 samples (as ``bench.py``)."""
    from channelestimationtransformer_torch.core.config import DataConfig, InformerConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.models.informer import build_informer

    cfg = cfg or InformerConfig(use_pallas=True)
    data = DataConfig()
    model = build_informer(cfg, device="cuda", seed=0)
    plain = build_informer(dataclasses.replace(cfg, use_pallas=False), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(samples, slots or data.slots, data.features, generator=gen, device="cuda")
    ds = WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                       snr_db=data.snr_db, device="cuda")
    return cfg, model, plain, ds


def _zero_counts(ops, mha):
    ops.bd_attention_fwd.launches = ops.bd_attention_bwd.launches = 0
    mha.mha_attention_fwd.launches = 0


def _counts(ops, mha):
    return dict(bd_fwd=ops.bd_attention_fwd.launches, bd_bwd=ops.bd_attention_bwd.launches,
                mha=mha.mha_attention_fwd.launches)


def _alternate(torch, run, rounds=12):
    """Host-clock seconds of ``run(name, i)`` for both paths in turns
    (kernel, plain, plain, kernel, ...), each ending in a synchronise."""
    times = {"kernel": [], "plain": []}
    for i in range(rounds):
        for name in (("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(name, i)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def _profile(torch, run, label, card, out_name):
    """Device busy share of ``run(name)`` for both paths under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    report, summary = [card], {}
    for name in ("kernel", "plain"):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        line = (f"profile {name} path: one {label}, wall {wall_us:.0f} us under the "
                f"profiler, device kernels {busy_us:.0f} us, busy share {busy_us / wall_us:.3f}")
        print(line, flush=True)
        summary[f"profile_{name}"] = dict(wall_us=wall_us, device_busy_us=busy_us)
        report += [line, events.table(sort_by="self_cuda_time_total", row_limit=30)]
    (OUT / out_name).write_text("\n".join(report) + "\n")
    return summary


def phase_eval_path(torch, ops, mha, card, profile, name="eval path", cfg=None,
                    samples=65536, slots=None, batch=256, route="bd_fwd"):
    """``eval_chunk`` of 8 batches through the kernels: every attention call
    on ``route`` (a key of :func:`_counts`) and none elsewhere, a finite
    NMSE, one batch against the plain path, and samples/s of both paths."""
    from torch.utils.flop_counter import FlopCounterMode

    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import eval_chunk

    cfg, model, plain, ds = _models_and_data(torch, cfg, samples, slots)
    n_batches = 8

    def run(m, seed):
        return eval_chunk(m, ds, num_batches=n_batches, batch_size=batch,
                          label_len=cfg.label_len,
                          generator=torch.Generator(device="cuda").manual_seed(seed))

    torch.cuda.synchronize()
    _zero_counts(ops, mha)
    res = run(model, 1)
    torch.cuda.synchronize()
    launches = _counts(ops, mha)
    expected = {key: 13 * n_batches if key == route else 0 for key in launches}
    nmse, split = res["nmse"].item(), res["split"].cpu().tolist()
    print(f"{name}: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, split "
          f"{[round(s, 6) for s in split]}, launches bd {launches['bd_fwd']}, bd backward "
          f"{launches['bd_bwd']}, mha {launches['mha']} (expected {expected['bd_fwd']}, "
          f"{expected['bd_bwd']}, {expected['mha']})", flush=True)
    if launches != expected:
        fail(f"kernels launched {launches} times on the {name}, not {expected}")
    if not (math.isfinite(nmse) and len(split) == cfg.pred_len
            and all(math.isfinite(s) for s in split)):
        fail(f"non-finite NMSE on the {name}")

    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        p_kernel, p_plain = model(x_enc, x_dec), plain(x_enc, x_dec)
    err = (p_kernel - p_plain).abs().max().item()
    ok = p_kernel.shape == target.shape and torch.allclose(
        p_kernel, p_plain, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
    print(f"{name} vs plain attention path, one batch: max_abs {err:.3e} "
          f"(rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"kernel path and plain path disagree on the {name}")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        plain(x_enc, x_dec)
    batch_flops = counter.get_total_flops()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}: {n_params:,} parameters, {batch_flops / 1e9:.1f} GFLOP per batch of "
          f"{batch} (FlopCounterMode, plain path)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = _alternate(torch, lambda path, i: run(model if path == "kernel" else plain, 100 + i))
    samples_per_chunk = n_batches * batch
    summary = {}
    for path, ts in times.items():
        ts = ts[2:]  # the first rounds warm up
        med = statistics.median(ts)
        tflops = n_batches * batch_flops / med / 1e12
        summary[path] = dict(chunk_ms_median=med * 1e3,
                             samples_per_s=samples_per_chunk / med, tflop_per_s=tflops,
                             chunk_ms=[t * 1e3 for t in ts])
        print(f"{name.replace(' path', '')} {path:6s} path: {samples_per_chunk / med:.1f} "
              f"samples/s, {tflops:.2f} TFLOP/s (median of {len(ts)} chunks of "
              f"{samples_per_chunk}, {med * 1e3:.3f} ms) on {card}", flush=True)
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if profile:
        summary.update(_profile(torch, lambda path: run(model if path == "kernel" else plain, 7),
                                "eval_chunk", card, f"profile_{name.replace(' ', '_')}.txt"))
    return dict(nmse=nmse, split=split, launches=launches, vs_plain_max_abs=err,
                parameters=n_params, batch_flops=batch_flops, **summary)


def phase_train_path(torch, ops, mha, card, profile):
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import create_train_state, train_chunk

    cfg, model, plain, ds = _models_and_data(torch)
    batch = 256

    # (a) One step's loss and gradients, kernel path vs plain path: the same
    # weights, batch and generator seed, hence the same dropout masks.
    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(3))
    results = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.train()
        pred = m(x_enc, x_dec, generator=torch.Generator(device="cuda").manual_seed(4))
        loss = nmse(pred, target)
        loss.backward()
        results[name] = (pred.detach(), loss.item(),
                         {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                         {n: b.clone() for n, b in m.named_buffers() if "running" in n})
        m.zero_grad(set_to_none=True)
    (pk, lk, gk, sk), (pp, lp, gp, sp) = results["kernel"], results["plain"]
    floor = 1e-3 * max(g.abs().max().item() for g in gp.values())
    grad_err = {n: (gk[n] - gp[n]).abs().max().item() / max(gp[n].abs().max().item(), floor)
                for n in gp}
    stat_err = max(((sk[n] - sp[n]).abs().max()).item() for n in sp)
    out_err = (pk - pp).abs().max().item()
    worst = max(grad_err, key=grad_err.get)
    ok = (math.isfinite(lk) and abs(lk - lp) <= MAIN_TOL[0] * abs(lp)
          and torch.allclose(pk, pp, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
          and max(grad_err.values()) <= GRAD_TOL and stat_err <= MAIN_TOL[1])
    print(f"train step, kernel path vs plain path (same weights, batch, masks): loss "
          f"{lk:.6f} vs {lp:.6f}, output max_abs {out_err:.3e} (rtol {MAIN_TOL[0]}, atol "
          f"{MAIN_TOL[1]}), {len(grad_err)} gradients, worst max_abs/max {grad_err[worst]:.3e} "
          f"at {worst} (limit {GRAD_TOL}), BatchNorm stats max_abs {stat_err:.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("kernel path and plain path disagree on one training step")

    # (b, c) train_chunk through the kernels: launch counts and a finite loss.
    train_cfg = TrainConfig(batch_size=batch, lr=1e-4)
    states = {"kernel": create_train_state(model, train_cfg),
              "plain": create_train_state(plain, train_cfg)}

    def run(name, seed, steps=TRAIN_STEPS):
        return train_chunk(states[name], ds, num_steps=steps, batch_size=batch,
                           label_len=cfg.label_len,
                           generator=torch.Generator(device="cuda").manual_seed(seed))

    torch.cuda.synchronize()
    _zero_counts(ops, mha)
    m = run("kernel", 5)
    torch.cuda.synchronize()
    launches = _counts(ops, mha)
    fwd, bwd = launches["bd_fwd"], launches["bd_bwd"]
    loss = m["loss_sum"].item() / TRAIN_STEPS
    split = (m["split_sum"] / TRAIN_STEPS).cpu().tolist()
    print(f"train path: train_chunk {TRAIN_STEPS} x {batch}: mean loss {loss:.6f}, split "
          f"{[round(s, 6) for s in split]}, forward launches {fwd}, backward launches {bwd} "
          f"(expected {13 * TRAIN_STEPS} each), mha launches {launches['mha']} (expected 0)",
          flush=True)
    if fwd != 13 * TRAIN_STEPS or bwd != 13 * TRAIN_STEPS or launches["mha"] != 0:
        fail(f"kernels launched {launches} times on the training path, "
             f"not {13 * TRAIN_STEPS} forward and backward, 0 mha")
    if not (math.isfinite(loss) and all(math.isfinite(s) for s in split)):
        fail("non-finite loss on the training path")

    # (d) Steady state, the two paths in turns.
    torch.cuda.reset_peak_memory_stats()
    times = _alternate(torch, lambda name, i: run(name, 100 + i), rounds=10)
    samples = TRAIN_STEPS * batch
    summary = {}
    for name, ts in times.items():
        ts = ts[2:]
        med = statistics.median(ts)
        summary[name] = dict(chunk_ms_median=med * 1e3, samples_per_s=samples / med,
                             chunk_ms=[t * 1e3 for t in ts])
        print(f"train {name:6s} path: {samples / med:.1f} samples/s (median of {len(ts)} "
              f"chunks of {TRAIN_STEPS} steps x {batch}, {med * 1e3:.3f} ms) on {card}",
              flush=True)
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if profile:  # (e)
        summary.update(_profile(torch, lambda name: run(name, 7), "train_chunk", card,
                                "profile_train.txt"))
    return dict(loss=loss, split=split, launches_fwd=fwd, launches_bwd=bwd,
                step_loss=(lk, lp), step_out_max_abs=out_err, step_grad_rel_err=grad_err,
                step_stats_max_abs=stat_err, **summary)


def _per_step(rows, key):
    """Sum of ``key`` over the 13 float32 calls of one batch or step (rows
    beyond the model count 0 times)."""
    return sum(r[key] * r.get("calls_per_batch", r.get("calls_per_step"))
               for r in rows if r["dtype"] == "float32")


def main(argv):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build
    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import mha_attention as mha
    from channelestimationtransformer_torch.core.config import InformerConfig

    OUT.mkdir(exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card} | torch {torch.__version__}, CUDA {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    libs = (ops.FWD_LIB, ops.BWD_LIB, mha.LIB)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        builds = list(pool.map(_build.build, libs))
    build_s = time.perf_counter() - t0
    for lib, log in builds:
        print(f"build: {lib.name} ({build_s:.2f} s for all {len(libs)})", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # Bring the card's clocks up before the first timed row.
    x = torch.randn(4096, 4096, device="cuda")
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()

    profile = "--profile" in argv
    eval_rows = phase_kernel(torch, F, ops.bd_attention, ops.bd_attention_reference,
                             [s + (B, H, E, E) for s in SHAPES])
    mha_rows = phase_kernel(torch, F, mha.mha_attention, mha.mha_attention_reference,
                            [s + (XL_B, XL_H, XL_E, XL_E) for s in XL_SHAPES]
                            + MHA_EXTRA_SHAPES, prefix="mha kernel", seed=2)
    fwd_rows, bwd_rows = phase_kernel_train(torch, F, ops)
    eval_path = phase_eval_path(torch, ops, mha, card, profile)
    xl_cfg = InformerConfig(d_model=1024, d_ff=4096, seq_len=256, use_pallas=True)
    xl_eval_path = phase_eval_path(torch, ops, mha, card, profile, name="xl eval path",
                                   cfg=xl_cfg, samples=4096, slots=xl_cfg.seq_len + 10,
                                   batch=64, route="mha")
    train_path = phase_train_path(torch, ops, mha, card, profile)

    per = "one training step: the 13 float32 calls at their flagship shapes (dropout 0.05)"
    tpu = "channelestimationtransformer_tpu/ops/pallas/"
    kernels = []
    for name, rows, launches, replaces, per in (
            ("bd_attention_fwd", fwd_rows, train_path["launches_fwd"],
             f"{tpu}bd_attention.py:121", per),
            ("bd_attention_bwd", bwd_rows, train_path["launches_bwd"],
             f"{tpu}bd_attention.py:153", per),
            ("mha_attention_fwd", mha_rows, xl_eval_path["launches"]["mha"],
             f"{tpu}attention.py:70, {tpu}attention.py:31",
             "one xl eval batch: the 13 float32 calls at their xl shapes (B 64, H 8, E 128)")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"channelestimationtransformer_torch/ops/cuda/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
            "ms": _per_step(rows, "ms"),
            "plain_ms": _per_step(rows, "plain_ms"),
            "bound_ms": _per_step(rows, "bound_ms"),
            "bound_by": ("bytes" if _per_step(rows, "bytes_ms") >= _per_step(rows, "ops_ms")
                         else "operations"),
            "library_ms": _per_step(rows, "library_ms"),
            "per": per,
        })
    kernels[0].update(eval_launches=eval_path["launches"]["bd_fwd"],
                      eval_ms=_per_step(eval_rows, "ms"),
                      eval_bound_ms=_per_step(eval_rows, "bound_ms"),
                      eval_library_ms=_per_step(eval_rows, "library_ms"))
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, kernel_rows=eval_rows, mha_kernel_rows=mha_rows,
        train_fwd_rows=fwd_rows, train_bwd_rows=bwd_rows, eval_path=eval_path,
        xl_eval_path=xl_eval_path, train_path=train_path, kernels=kernels), indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
