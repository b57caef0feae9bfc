"""Drive the PyTorch port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py            # the check, as run on the card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of eval and training

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and convs;
2. build: both CUDA kernel libraries, compiled in parallel with nvcc from the
   sources here;
3. kernel, eval: the attention forward kernel (dropout 0) against its plain
   version at the six flagship shape classes in float32 and bfloat16, with
   kernel, plain and ``F.scaled_dot_product_attention`` (yardstick only)
   times;
4. kernel, training: at the same shapes and dtypes, the forward kernel with
   dropout 0.05 and its row log-sum-exp against the plain version on the
   same seed, the kernel's dropout mask against ``dropout_keep_mask``
   (exact), and the backward kernel's dQ/dK/dV against
   ``bd_attention_bwd_reference``, each timed beside its bound and the SDPA
   yardstick;
5. eval path: ``build_informer(InformerConfig(use_pallas=True))`` at full
   width and ``eval_chunk`` over 8 batches of 256 from a 65,536-sample
   dataset resident on the card, with the forward kernel's launch count,
   NMSE, a comparison with the plain attention path on one batch, and
   steady-state eval samples/s;
6. training path: the same model in train mode (dropout 0.05). One step
   through the kernels and one through the plain attention path from the
   same weights, batch and generator seed (so the same dropout masks),
   compared loss, output and gradient by gradient; ``train_chunk`` with the
   kernels' launch counts and a finite loss; steady-state training
   samples/s of both paths.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/chip_smoke.json``.
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


def fwd_bound(l_q, l_k, causal, dtype, with_lse=False):
    """Least time for one forward: Q, K, V read once and O (and lse) written
    once over HBM, or the matmul FLOPs of the unmasked (row, key) pairs
    (4*E each) over the dtype's peak rate, whichever is larger. The dropout
    mask's integer work is not counted."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * B * H * E * (2 * l_q + 2 * l_k) + (4 * B * H * l_q if with_lse else 0)
    return _bound(nbytes, 4 * B * H * E * _pairs(l_q, l_k, causal), dtype)


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


def _inputs(torch, gen, dtype, l_q, l_k):
    return tuple(torch.randn(B, l, H, E, generator=gen, device="cuda").to(dtype)
                 for l in (l_q, l_k, l_k))


def phase_kernel(torch, F, ops):
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, l_q, l_k, causal, calls in SHAPES:
            q, k, v = _inputs(torch, gen, dtype, l_q, l_k)
            got = ops.bd_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = ops.bd_attention_reference(q.float(), k.float(), v.float(), causal=causal)
            rtol, atol = TOL[dtype_name]
            abs_err, rel_err, ok = _compare(torch, got, want.to(dtype), TOL[dtype_name])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            def kernel():
                return ops.bd_attention(q, k, v, causal=causal)
            ms = time_ms(torch, kernel)
            kernel_eager_ms = eager_ms(torch, kernel)
            plain_ms = time_ms(torch, lambda: ops.bd_attention_reference(q, k, v, causal=causal))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            row = dict(shape=label, dtype=dtype_name, l_q=l_q, l_k=l_k, causal=causal,
                       calls_per_batch=calls, max_abs_err=abs_err, max_rel_err=rel_err,
                       rtol=rtol, atol=atol, ms=ms, eager_ms=kernel_eager_ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       **fwd_bound(l_q, l_k, causal, dtype_name))
            rows.append(row)
            print(f"kernel {label:22s} {dtype_name:8s} max_abs {abs_err:.3e} max_rel "
                  f"{rel_err:.3e} (rtol {rtol}, atol {atol}) {'ok' if ok else 'MISMATCH'} | "
                  f"kernel {ms * 1e3:.1f} us (eager {kernel_eager_ms * 1e3:.1f}), plain "
                  f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']})", flush=True)
            if not ok:
                fail(f"kernel disagrees with its plain version at {label} {dtype_name}")
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
                       **fwd_bound(l_q, l_k, causal, dtype_name, with_lse=True))
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


def _flagship(torch):
    from channelestimationtransformer_torch.core.config import DataConfig, InformerConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.models.informer import build_informer

    cfg = InformerConfig(use_pallas=True)
    data = DataConfig()
    model = build_informer(cfg, device="cuda", seed=0)
    plain = build_informer(dataclasses.replace(cfg, use_pallas=False), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(65536, data.slots, data.features, generator=gen, device="cuda")
    ds = WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                       snr_db=data.snr_db, device="cuda")
    return cfg, model, plain, ds


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


def phase_eval_path(torch, ops, card, profile):
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import eval_chunk

    cfg, model, plain, ds = _flagship(torch)
    n_batches, batch = 8, 256

    def run(m, seed):
        return eval_chunk(m, ds, num_batches=n_batches, batch_size=batch,
                          label_len=cfg.label_len,
                          generator=torch.Generator(device="cuda").manual_seed(seed))

    torch.cuda.synchronize()
    ops.bd_attention_fwd.launches = ops.bd_attention_bwd.launches = 0
    res = run(model, 1)
    torch.cuda.synchronize()
    launches, bwd_launches = ops.bd_attention_fwd.launches, ops.bd_attention_bwd.launches
    nmse, split = res["nmse"].item(), res["split"].cpu().tolist()
    print(f"eval path: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, split "
          f"{[round(s, 6) for s in split]}, kernel launches {launches} "
          f"(expected {13 * n_batches}), backward launches {bwd_launches} (expected 0)",
          flush=True)
    if launches != 13 * n_batches or bwd_launches != 0:
        fail(f"kernels launched {launches}/{bwd_launches} times on the eval path, "
             f"not {13 * n_batches}/0")
    if not (math.isfinite(nmse) and len(split) == cfg.pred_len
            and all(math.isfinite(s) for s in split)):
        fail("non-finite NMSE on the eval path")

    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        p_kernel, p_plain = model(x_enc, x_dec), plain(x_enc, x_dec)
    err = (p_kernel - p_plain).abs().max().item()
    ok = p_kernel.shape == target.shape and torch.allclose(
        p_kernel, p_plain, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
    print(f"eval path vs plain attention path, one batch: max_abs {err:.3e} "
          f"(rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("kernel path and plain path disagree on the eval path")

    torch.cuda.reset_peak_memory_stats()
    times = _alternate(torch, lambda name, i: run(model if name == "kernel" else plain, 100 + i))
    samples = n_batches * batch
    summary = {}
    for name, ts in times.items():
        ts = ts[2:]  # the first rounds warm up
        med = statistics.median(ts)
        summary[name] = dict(chunk_ms_median=med * 1e3, samples_per_s=samples / med,
                             chunk_ms=[t * 1e3 for t in ts])
        print(f"eval {name:6s} path: {samples / med:.1f} samples/s (median of {len(ts)} "
              f"chunks of {samples}, {med * 1e3:.3f} ms) on {card}", flush=True)
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if profile:
        summary.update(_profile(torch, lambda name: run(model if name == "kernel" else plain, 7),
                                "eval_chunk", card, "profile_eval.txt"))
    return dict(nmse=nmse, split=split, launches=launches, vs_plain_max_abs=err, **summary)


def phase_train_path(torch, ops, card, profile):
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import create_train_state, train_chunk

    cfg, model, plain, ds = _flagship(torch)
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
    ops.bd_attention_fwd.launches = ops.bd_attention_bwd.launches = 0
    m = run("kernel", 5)
    torch.cuda.synchronize()
    fwd, bwd = ops.bd_attention_fwd.launches, ops.bd_attention_bwd.launches
    loss = m["loss_sum"].item() / TRAIN_STEPS
    split = (m["split_sum"] / TRAIN_STEPS).cpu().tolist()
    print(f"train path: train_chunk {TRAIN_STEPS} x {batch}: mean loss {loss:.6f}, split "
          f"{[round(s, 6) for s in split]}, forward launches {fwd}, backward launches {bwd} "
          f"(expected {13 * TRAIN_STEPS} each)", flush=True)
    if fwd != 13 * TRAIN_STEPS or bwd != 13 * TRAIN_STEPS:
        fail(f"kernels launched {fwd}/{bwd} times on the training path, "
             f"not {13 * TRAIN_STEPS} each")
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
    """Sum of ``key`` over the 13 float32 calls of one batch or step."""
    return sum(r[key] * r.get("calls_per_batch", r.get("calls_per_step"))
               for r in rows if r["dtype"] == "float32")


def main(argv):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build
    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops

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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = list(pool.map(_build.build, (ops.FWD_LIB, ops.BWD_LIB)))
    build_s = time.perf_counter() - t0
    for lib, log in builds:
        print(f"build: {lib.name} ({build_s:.2f} s for both)", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # Bring the card's clocks up before the first timed row.
    x = torch.randn(4096, 4096, device="cuda")
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()

    eval_rows = phase_kernel(torch, F, ops)
    fwd_rows, bwd_rows = phase_kernel_train(torch, F, ops)
    eval_path = phase_eval_path(torch, ops, card, "--profile" in argv)
    train_path = phase_train_path(torch, ops, card, "--profile" in argv)

    per = "one training step: the 13 float32 calls at their flagship shapes (dropout 0.05)"
    kernels = []
    for name, rows, launches, replaces in (
            ("bd_attention_fwd", fwd_rows, train_path["launches_fwd"], 121),
            ("bd_attention_bwd", bwd_rows, train_path["launches_bwd"], 153)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"channelestimationtransformer_torch/ops/cuda/csrc/{name}.cu",
            "replaces": f"channelestimationtransformer_tpu/ops/pallas/bd_attention.py:{replaces}",
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
    kernels[0].update(eval_launches=eval_path["launches"], eval_ms=_per_step(eval_rows, "ms"),
                      eval_bound_ms=_per_step(eval_rows, "bound_ms"),
                      eval_library_ms=_per_step(eval_rows, "library_ms"))
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, kernel_rows=eval_rows, train_fwd_rows=fwd_rows,
        train_bwd_rows=bwd_rows, eval_path=eval_path, train_path=train_path,
        kernels=kernels), indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
