"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py            # the check, as run on the card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of eval_chunk

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and convs;
2. build: the CUDA kernel library, compiled with nvcc from the sources here;
3. kernel: the attention kernel against its plain version at the six
   flagship shape classes in float32 and bfloat16, with kernel, plain and
   ``F.scaled_dot_product_attention`` (yardstick only) times;
4. main path: ``build_informer(InformerConfig(use_pallas=True))`` at full
   width and ``eval_chunk`` over 8 batches of 256 from a 65,536-sample
   dataset resident on the card, with the kernel's launch count, NMSE, a
   comparison with the plain attention path on one batch, and steady-state
   eval samples/s.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
# (label, l_q, l_k, causal, calls per eval batch) at B 256, H 8, E 16
SHAPES = [
    ("enc L=90", 90, 90, False, 1),
    ("enc L=45", 45, 45, False, 2),
    ("enc L=23", 23, 23, False, 2),
    ("enc L=12", 12, 12, False, 2),
    ("dec self L=15 causal", 15, 15, True, 3),
    ("cross 15x24", 15, 24, False, 3),
]
B, H, E = 256, 8, 16
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}  # (rtol, atol)
MAIN_TOL = (1e-3, 1e-4)  # kernel path vs plain path, whole model, TF32 off
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


def bound(l_q, l_k, causal, dtype):
    """Least time for one call: each input read once and the output written
    once over HBM, or the matmul FLOPs of the unmasked (row, key) pairs over
    the peak rate for the dtype, whichever is larger."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * B * H * E * (2 * l_q + 2 * l_k)
    pairs = sum(min(i + 1, l_k) for i in range(l_q)) if causal else l_q * l_k
    flops = 4 * B * H * E * pairs
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3  # ms, ms


def phase_kernel(torch, F, ops):
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, l_q, l_k, causal, calls in SHAPES:
            q, k, v = (torch.randn(B, l, H, E, generator=gen, device="cuda").to(dtype)
                       for l in (l_q, l_k, l_k))
            got = ops.bd_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = ops.bd_attention_reference(q.float(), k.float(), v.float(), causal=causal)
            if dtype != torch.float32:
                want = want.to(dtype)
            diff = (got.float() - want.float()).abs()
            abs_err = diff.max().item()
            rel_err = (diff / want.float().abs().clamp_min(1e-3)).max().item()
            rtol, atol = TOL[dtype_name]
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), rtol=rtol, atol=atol)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            def kernel():
                return ops.bd_attention(q, k, v, causal=causal)
            ms = time_ms(torch, kernel)
            kernel_eager_ms = eager_ms(torch, kernel)
            plain_ms = time_ms(torch, lambda: ops.bd_attention_reference(q, k, v, causal=causal))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bytes_ms, ops_ms = bound(l_q, l_k, causal, dtype_name)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            row = dict(shape=label, dtype=dtype_name, l_q=l_q, l_k=l_k, causal=causal,
                       calls_per_batch=calls, max_abs_err=abs_err, max_rel_err=rel_err,
                       rtol=rtol, atol=atol, ms=ms, eager_ms=kernel_eager_ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
                       ops_ms=ops_ms)
            rows.append(row)
            print(f"kernel {label:22s} {dtype_name:8s} max_abs {abs_err:.3e} max_rel "
                  f"{rel_err:.3e} (rtol {rtol}, atol {atol}) {'ok' if ok else 'MISMATCH'} | "
                  f"kernel {ms * 1e3:.1f} us (eager {kernel_eager_ms * 1e3:.1f}), plain "
                  f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by})",
                  flush=True)
            if not ok:
                fail(f"kernel disagrees with its plain version at {label} {dtype_name}")
    return rows


def phase_main_path(torch, ops, card, profile):
    from channelestimationtransformer_torch.core.config import DataConfig, InformerConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.train.trainer import eval_chunk

    cfg = InformerConfig(use_pallas=True)
    data = DataConfig()
    model = build_informer(cfg, device="cuda", seed=0)
    plain = build_informer(dataclasses.replace(cfg, use_pallas=False), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(65536, data.slots, data.features, generator=gen, device="cuda")
    ds = WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                       snr_db=data.snr_db, device="cuda")
    n_batches, batch = 8, 256

    def run(m, seed):
        return eval_chunk(m, ds, num_batches=n_batches, batch_size=batch,
                          label_len=cfg.label_len,
                          generator=torch.Generator(device="cuda").manual_seed(seed))

    torch.cuda.synchronize()
    ops.bd_attention.launches = 0
    res = run(model, 1)
    torch.cuda.synchronize()
    launches = ops.bd_attention.launches
    nmse, split = res["nmse"].item(), res["split"].cpu().tolist()
    print(f"main path: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, split "
          f"{[round(s, 6) for s in split]}, kernel launches {launches} "
          f"(expected {13 * n_batches})", flush=True)
    if launches != 13 * n_batches:
        fail(f"kernel launched {launches} times on the main path, not {13 * n_batches}")
    if not (math.isfinite(nmse) and len(split) == cfg.pred_len
            and all(math.isfinite(s) for s in split)):
        fail("non-finite NMSE on the main path")

    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        p_kernel, p_plain = model(x_enc, x_dec), plain(x_enc, x_dec)
    err = (p_kernel - p_plain).abs().max().item()
    ok = p_kernel.shape == target.shape and torch.allclose(
        p_kernel, p_plain, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
    print(f"main path vs plain attention path, one batch: max_abs {err:.3e} "
          f"(rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("kernel path and plain path disagree on the main path")

    # Steady state, the two paths in turns (kernel, plain, plain, kernel, ...).
    times = {"kernel": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(12):
        order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(model if name == "kernel" else plain, 100 + i)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
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
        from torch.profiler import ProfilerActivity, profile as torch_profile

        report = [card]
        for name, m in (("kernel", model), ("plain", plain)):
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(m, 7)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            events = prof.key_averages()
            busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            line = (f"profile {name} path: one eval_chunk, wall {wall_us:.0f} us under the "
                    f"profiler, device kernels {busy_us:.0f} us, busy share "
                    f"{busy_us / wall_us:.3f}")
            print(line, flush=True)
            summary[f"profile_{name}"] = dict(wall_us=wall_us, device_busy_us=busy_us)
            report += [line, events.table(sort_by="self_cuda_time_total", row_limit=25)]
        (OUT / "profile_eval.txt").write_text("\n".join(report) + "\n")
    return dict(nmse=nmse, split=split, launches=launches, vs_plain_max_abs=err, **summary)


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
    lib, log = _build.build(ops.LIB_NAME)
    build_s = time.perf_counter() - t0
    print(f"build: {lib.name} in {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    rows = phase_kernel(torch, F, ops)
    main_path = phase_main_path(torch, ops, card, "--profile" in argv)

    f32 = [r for r in rows if r["dtype"] == "float32"]

    def per_batch(key):
        return sum(r[key] * r["calls_per_batch"] for r in f32)

    kernels = [{
        "name": "bd_attention_fwd",
        "route": "cuda",
        "source": "channelestimationtransformer_torch/ops/cuda/csrc/bd_attention_fwd.cu",
        "replaces": "channelestimationtransformer_tpu/ops/pallas/bd_attention.py:121",
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": per_batch("ms"),
        "plain_ms": per_batch("plain_ms"),
        "bound_ms": per_batch("bound_ms"),
        "bound_by": "bytes" if per_batch("bytes_ms") >= per_batch("ops_ms") else "operations",
        "library_ms": per_batch("library_ms"),
        "per": "one eval batch: the 13 float32 calls at their flagship shapes",
    }]
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, kernel_rows=rows, main_path=main_path,
        kernels=kernels), indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
