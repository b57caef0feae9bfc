"""Drive the PyTorch port's serving, quantized serving and training paths
on one NVIDIA card.

    python3 chip_smoke.py            # the check, as run on the card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of the eval and training paths

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and convs;
2. build: the five CUDA kernel libraries, compiled in parallel with nvcc
   from the sources here; per library its kernels' registers, spill bytes
   and static shared memory from ``-Xptxas -v`` (the full logs go beside
   ``chip_smoke.json``, as ``ptxas_<name>.txt``) and its count of
   tensor-core MMA instructions (HMMA) in the SASS; the three attention
   libraries must show HMMA > 0 and no spills;
3. kernel, eval: the bd-attention forward kernel (dropout 0) against its
   plain version at the six flagship shape classes in float32 and bfloat16,
   with kernel, plain and ``F.scaled_dot_product_attention`` (yardstick
   only) times;
4. kernel, xl eval: the mha-attention forward kernel against its plain
   version at the six shape classes of the xl model (B 64, H 8, E 128) and
   two shapes beyond the model (D != E; a long non-square causal shape), in
   float32 and bfloat16, timed likewise;
5. quant fixed: the fixed-point kernel against its plain version bit for
   bit at 128 x 128, 128 x 64, 2^20, 2^24 and 1,000,003 elements, formats
   (wl, fl) (8, 4), (4, 0), (15, 11), (2, -2), symmetric and clamp on and
   off, nearest and stochastic; stochastic rounding unbiased within 4
   sigma; kernel, plain and ``torch.fake_quantize_per_tensor_affine``
   (yardstick) times; then the grouped launch over the flagship's 72 PTQ
   tensors (one launch a quantization) against the grouped plain version
   bit for bit in every format x symmetric x clamp x rounding, timed beside
   72 single-tensor launches, its bound, 72 ``fake_quantize`` calls and one
   ``fake_quantize`` over a flat buffer of the same 1,015,808 elements;
6. codeword: the nearest-codeword kernel against its plain version bit for
   bit for ten codebooks (LSQ-fibbinary of 4 to 11 bits, fibbinary(8, 4),
   Fibonacci(8, 4)) on inputs with every codeword, every tie and +-0;
   kernel, plain and ``torch.bucketize`` (yardstick) times at the LSQ
   path's sizes and at 2^24 x 287 entries; then its LSQ mode (the whole
   ``lsq_quantize`` chain in one launch) against the eager chain bit for
   bit at the flagship's three layer shapes, nbits 4 to 11, two step sizes,
   with values past Qn / Qp, ties, +-0 and NaN, timed beside the plain snap
   mode and the eager chain;
7. kernel, training: at the flagship shapes in both dtypes, the forward
   kernel with dropout 0.05 and its row log-sum-exp against the plain
   version on the same seed, the kernel's dropout mask against ``dropout_keep_mask``
   (exact), and the backward kernel's dQ/dK/dV against
   ``bd_attention_bwd_reference`` on the kernel forward's output and lse,
   and against the plain backward on the plain forward's, each timed beside
   its bound and the SDPA yardstick;
8. eval path: ``build_informer(InformerConfig(use_pallas=True))`` at full
   width and ``eval_chunk`` over 8 batches of 256 from a 65,536-sample
   dataset resident on the card, with the kernels' launch counts (all 104
   attention calls through the bd forward kernel), NMSE, a comparison with
   the plain attention path on one batch, the model's parameters and FLOPs
   per batch, and steady-state eval samples/s and TFLOP/s;
9. xl eval path: the same at the xl width (d_model 1024, d_ff 4096, seq_len
   256; ``experiments/scale_demo.py``'s "xl" row), 8 batches of 64 from a
   4,096 x 266 x 16 dataset: all 104 attention calls through the mha
   kernel, none through the bd kernels;
10. ptq eval path: the flagship's FP32 weights quantized at wl 8, fl 4
   (nearest, then stochastic) by ``apply_weight_quant`` with one
   ``FixedPointWeightQuant``: one grouped fixed-point launch a
   quantization, the 72 tensors equal to the plain path's bit for bit,
   ``eval_chunk`` of the quantized copy with 104 bd launches; the time of a
   24-point sweep (``experiments/ptq_sweep.py``'s wl 4-15 x two roundings,
   quantize only), in turns with the same sweep through per-tensor
   closures (72 launches a quantization); eval samples/s of the quantized
   and the FP32 weights;
11. lsq-fibbinary eval path: ``InformerConfig(use_pallas=True, lsq_nbits=8,
   lsq_fibbinary=True)`` through ``eval_chunk`` as in 8: 576 codeword and
   104 bd launches in 8 batches, one batch against the plain path (the
   snap's plain version, plain attention), eval samples/s beside the FP32
   flagship's in the same turns (each snap is the codeword kernel's LSQ
   mode: one launch a layer);
12. training path: the flagship model in train mode (dropout 0.05). One step
   through the kernels and one through the plain attention path from the
   same weights, batch and generator seed (so the same dropout masks),
   compared loss, output and gradient by gradient; ``train_chunk`` with the
   kernels' launch counts and a finite loss; steady-state training
   samples/s of both paths.

With ``--profile`` each path's line also gives its device kernel launches
per chunk. The last three lines are the card's name and power limit, the kernels' JSON
record and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores
TENSOR_CORE_LIBS = ("bd_attention_fwd", "bd_attention_bwd", "mha_attention_fwd")
# Attention products (the bound of every attention row, forward and
# backward). The tensor cores are the card's fastest f32-accurate route: a
# TF32 pass keeps 10 mantissa bits, so an f32 product takes three passes on
# split operands (hi*hi + hi*lo + lo*hi, csrc/mma_tf32.cuh), 495 / 3
# TFLOP/s. The quant kernels' work is comparisons and stays at the f32
# CUDA-core rate.
ATTN_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
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
# The flagship's 72 quantized tensors (PTQ and LSQ): (label, elements, count).
QUANT_TENSORS = [("128x128", 128 * 128, 52), ("128x64", 128 * 64, 20)]
FIXED_SIZES = QUANT_TENSORS + [("2^20", 1 << 20, 0), ("2^24", 1 << 24, 0),
                               ("1,000,003", 1_000_003, 0)]
FIXED_FORMATS = [(8, 4), (4, 0), (15, 11), (2, -2)]  # (wl, fl); each spans +-8
PTQ_WL, PTQ_FL = 8, 4
# experiments/ptq_sweep.py:95-97 at its defaults: (wl, fl = wl - 4, rounding).
SWEEP = [(wl, wl - 4, r) for r in ("nearest", "stochastic") for wl in range(4, 16)]
LSQ_NBITS = 8
CODEWORD_SIZES = QUANT_TENSORS + [("2^20", 1 << 20, 0)]
# Checked and timed beside the LSQ path's rows: the largest codebook at 2^24.
CODEWORD_BIG = ("lsq_fibbinary(11)", ("2^24", 1 << 24, 0))
# The flagship's 72 LSQ layer weights by shape ([out, in]): attention
# projections, FFN in and FFN out.
LSQ_SHAPES = [("128x128", (128, 128), 52), ("64x128", (64, 128), 10), ("128x64", (128, 64), 10)]
LSQ_STEP = 2.0 ** -5  # a power of two: grad_scale's value is the step itself, ties stay exact
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


def _ptxas_summary(log):
    """Kernels, registers, spill bytes and static shared memory over every
    kernel of one ``nvcc -Xptxas -v`` log (dynamic shared memory is set at
    launch and not in the log)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    return dict(kernels=len(re.findall(r"Compiling entry function", log)),
                registers_min=min(regs, default=0), registers_max=max(regs, default=0),
                spill_stores=sum(int(a) for a, _ in spills),
                spill_loads=sum(int(b) for _, b in spills), smem_max=max(smem, default=0))


def _hmma_count(lib):
    """Tensor-core MMA instructions (HMMA) in a library's SASS, by cuobjdump
    beside nvcc; None where the toolkit has no cuobjdump."""
    from channelestimationtransformer_torch.ops.cuda import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return len(re.findall(r"\bHMMA\.", sass))


def _pairs(l_q, l_k, causal):
    return sum(min(i + 1, l_k) for i in range(l_q)) if causal else l_q * l_k


def _bound(nbytes, flops, dtype, peak=PEAK_FLOPS):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak[dtype] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def fwd_bound(l_q, l_k, causal, dtype, *, b, h, e, d=None, with_lse=False):
    """Least time for one forward: Q, K, V read once and O (and lse) written
    once over HBM, or the matmul FLOPs of the unmasked (row, key) pairs
    (2*(E + D) each) over the dtype's tensor-core rate (f32: split-TF32),
    whichever is larger. The dropout mask's integer work is not counted."""
    d = e if d is None else d
    size = 4 if dtype == "float32" else 2
    nbytes = (size * b * h * (e + d) * (l_q + l_k)
              + (4 * b * h * l_q if with_lse else 0))
    return _bound(nbytes, 2 * b * h * (e + d) * _pairs(l_q, l_k, causal), dtype,
                  ATTN_PEAK_FLOPS)


def bwd_bound(l_q, l_k, causal, dtype):
    """Least time for one backward: Q, K, V, O, dO and lse read once, dQ,
    dK, dV written once; or 10*E FLOPs per unmasked pair (QK^T and dO V^T
    once each, dQ, dK, dV) at the tensor-core rate, whichever is larger."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * B * H * E * (4 * l_q + 4 * l_k) + 4 * B * H * l_q
    return _bound(nbytes, 10 * B * H * E * _pairs(l_q, l_k, causal), dtype, ATTN_PEAK_FLOPS)


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
            # The plain forward in the inputs' dtype (f32 math, output rounded to it).
            plain_o, plain_lse = ops._reference_forward(q, k, v, seed=seed, with_lse=True, **kw)
            abs_err, rel_err, ok = _compare(torch, o, plain_o, TOL[dtype_name])
            lse_err, _, lse_ok = _compare(torch, lse, plain_lse, (1e-5, 1e-5))
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
            # The plain pair: the plain backward on the plain forward's output and lse.
            pair = ops.bd_attention_bwd_reference(q.float(), k.float(), v.float(),
                                                  plain_o.float(), do.float(), plain_lse, seed,
                                                  **kw)
            pair_errs = [_compare(torch, g, w.to(dtype), BWD_TOL[dtype_name])
                         for g, w in zip(got, pair)]
            ok = all(e[2] for e in errs + pair_errs)

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
                       pair_max_abs_err=max(e[0] for e in pair_errs),
                       rtol=BWD_TOL[dtype_name][0], atol=BWD_TOL[dtype_name][1],
                       ms=time_ms(torch, bwd), eager_ms=eager_ms(torch, bwd),
                       plain_ms=time_ms(torch, lambda: ops.bd_attention_bwd_reference(
                           q, k, v, o, do, lse, seed, **kw)),
                       library_ms=lib_ms, **bwd_bound(l_q, l_k, causal, dtype_name))
            bwd_rows.append(row)
            print(f"train bwd {label:22s} {dtype_name:8s} dQ/dK/dV max_abs "
                  f"{' '.join(f'{e[0]:.2e}' for e in errs)}, vs the plain pair "
                  f"{' '.join(f'{e[0]:.2e}' for e in pair_errs)} (rtol {row['rtol']}, atol "
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


# Printed names of the kernel wrappers' launch counters (keys of _counts).
COUNT_LABELS = dict(bd_fwd="bd", bd_bwd="bd backward", mha="mha", fixed="fixed",
                    codeword="codeword")


def _zero_counts(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def _counts(wrappers):
    return {key: fn.launches for key, fn in wrappers.items()}


def _launch_report(launches, expected):
    return (", ".join(f"{COUNT_LABELS[k]} {launches[k]}" for k in launches) + " (expected "
            + ", ".join(str(expected[k]) for k in launches) + ")")


def _alternate(torch, run, rounds=12, names=("kernel", "plain")):
    """Host-clock seconds of ``run(name, i)`` for every path in turns
    (kernel, plain, plain, kernel, ...), each ending in a synchronise."""
    times = {name: [] for name in names}
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
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
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(getattr(e, "self_device_time_total", 0) for e in device)
        kernels = sum(e.count for e in device)
        line = (f"profile {name} path: one {label}, wall {wall_us:.0f} us under the "
                f"profiler, device kernels {busy_us:.0f} us in {kernels} launches, busy share "
                f"{busy_us / wall_us:.3f}")
        print(line, flush=True)
        summary[f"profile_{name}"] = dict(wall_us=wall_us, device_busy_us=busy_us,
                                          device_kernels=kernels)
        report += [line, events.table(sort_by="self_cuda_time_total", row_limit=30)]
    (OUT / out_name).write_text("\n".join(report) + "\n")
    return summary


def phase_eval_path(torch, wrappers, card, profile, name="eval path", cfg=None,
                    samples=65536, slots=None, batch=256, expected=None, beside=None):
    """``eval_chunk`` of 8 batches through the kernels: the launch counts
    ``expected`` (by key of :func:`_counts`; by default every attention call
    on the bd forward kernel) and none elsewhere, a finite NMSE, one batch
    against the plain path, and samples/s of both paths and of the
    ``beside`` models (name -> model), all in turns."""
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
    _zero_counts(wrappers)
    res = run(model, 1)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    expected = {key: (expected or {"bd_fwd": 13 * n_batches}).get(key, 0) for key in launches}
    nmse, split = res["nmse"].item(), res["split"].cpu().tolist()
    print(f"{name}: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, split "
          f"{[round(s, 6) for s in split]}, launches {_launch_report(launches, expected)}",
          flush=True)
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
    models = {"kernel": model, "plain": plain, **(beside or {})}
    times = _alternate(torch, lambda path, i: run(models[path], 100 + i), names=tuple(models))
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


def phase_train_path(torch, wrappers, card, profile):
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
    _zero_counts(wrappers)
    m = run("kernel", 5)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    fwd, bwd = launches["bd_fwd"], launches["bd_bwd"]
    loss = m["loss_sum"].item() / TRAIN_STEPS
    split = (m["split_sum"] / TRAIN_STEPS).cpu().tolist()
    print(f"train path: train_chunk {TRAIN_STEPS} x {batch}: mean loss {loss:.6f}, split "
          f"{[round(s, 6) for s in split]}, forward launches {fwd}, backward launches {bwd} "
          f"(expected {13 * TRAIN_STEPS} each), mha launches {launches['mha']} (expected 0), "
          f"quant launches {launches['fixed'] + launches['codeword']} (expected 0)", flush=True)
    if launches != dict(bd_fwd=13 * TRAIN_STEPS, bd_bwd=13 * TRAIN_STEPS, mha=0, fixed=0,
                        codeword=0):
        fail(f"kernels launched {launches} times on the training path, "
             f"not {13 * TRAIN_STEPS} forward and backward, 0 mha, 0 quant")
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

def _fixed_input(torch, n, gen):
    """Normal values over twice the formats' range (+-8), with exact
    midpoints of each format's grid written into a slice of their own and
    +-0 at the start."""
    x = torch.randn(n, generator=gen, device="cuda") * 4
    k = n // 16
    for j, (_, fl) in enumerate(FIXED_FORMATS):
        part = x[k * (j + 1):k * (j + 2)]
        part.copy_((torch.floor(part * 2.0 ** fl) + 0.5) / 2.0 ** fl)
    x[:2] = torch.tensor([0.0, -0.0], device="cuda")[:n]
    return x


def phase_fixed_kernel(torch, quant, draw_seed):
    """The fixed-point kernel against its plain version, bit for bit, at
    every size x format x symmetric x clamp x rounding; stochastic rounding
    unbiased; then kernel, plain, ``torch.fake_quantize_per_tensor_affine``
    (nearest only, yardstick) times at (8, 4), clamp, per size."""
    rows, checks = [], 0
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, n, count in FIXED_SIZES:
        x = _fixed_input(torch, n, gen)
        for wl, fl in FIXED_FORMATS:
            for symmetric in (False, True):
                for clamp in (True, False):
                    for stochastic in (False, True):
                        kw = dict(clamp=clamp, symmetric=symmetric, stochastic=stochastic,
                                  seed=draw_seed(gen, "cuda") if stochastic else None)
                        got = quant.fused_fixed_point_quantize(x, wl, fl, **kw)
                        torch.cuda.synchronize()
                        if not torch.equal(got, quant.fixed_point_quantize_reference(
                                x, wl, fl, **kw)):
                            fail(f"fixed-point kernel differs from its plain version at {label}, "
                                 f"wl {wl} fl {fl} symmetric {symmetric} clamp {clamp} "
                                 f"stochastic {stochastic}")
                        checks += 1
        # Stochastic rounding is unbiased: each error lies in (-res, res) with
        # variance <= res^2 / 4, so over m unclamped elements the mean error
        # stays within 4 sigma = 2 res / sqrt(m).
        res = 2.0 ** -PTQ_FL
        q = quant.fused_fixed_point_quantize(x, PTQ_WL, PTQ_FL, stochastic=True,
                                             seed=draw_seed(gen, "cuda"))
        inside = x.abs() < 2.0 ** (PTQ_WL - PTQ_FL - 1) - 2 * res
        m = int(inside.sum())
        bias = (q.double() - x.double())[inside].mean().item()
        bias_limit = 2 * res / math.sqrt(m)
        qmin, qmax = -(2 ** (PTQ_WL - 1)), 2 ** (PTQ_WL - 1) - 1

        def library():
            return torch.fake_quantize_per_tensor_affine(x, 2.0 ** -PTQ_FL, 0, qmin, qmax)
        library_equal = torch.equal(library(), quant.fused_fixed_point_quantize(x, PTQ_WL, PTQ_FL))
        plain_reps = dict(reps=5, inner=3) if n >= 1 << 20 else {}
        for stochastic in (False, True):
            kw = dict(stochastic=stochastic, seed=draw_seed(gen, "cuda") if stochastic else None)

            def kernel():
                return quant.fused_fixed_point_quantize(x, PTQ_WL, PTQ_FL, **kw)
            row = dict(size=label, elements=n, per_quantisation=count, wl=PTQ_WL, fl=PTQ_FL,
                       rounding="stochastic" if stochastic else "nearest", max_abs_err=0.0,
                       ms=time_ms(torch, kernel), eager_ms=eager_ms(torch, kernel),
                       plain_ms=time_ms(torch, lambda: quant.fixed_point_quantize_reference(
                           x, PTQ_WL, PTQ_FL, **kw), **plain_reps),
                       library_ms=None if stochastic else time_ms(torch, library),
                       library_equal=None if stochastic else library_equal,
                       stochastic_bias=bias if stochastic else None,
                       stochastic_bias_limit=bias_limit if stochastic else None,
                       **_bound(8 * n, 4 * n, "float32"))
            rows.append(row)
            lib = (f"fake_quantize {row['library_ms'] * 1e3:.1f} us "
                   f"({'equal' if library_equal else 'differs'})" if not stochastic
                   else f"mean error {bias:.2e} (limit {bias_limit:.2e})")
            print(f"quant fixed {label:10s} {row['rounding']:10s} wl {PTQ_WL} fl {PTQ_FL}: "
                  f"kernel = plain bit for bit ({checks} settings so far) | kernel "
                  f"{row['ms'] * 1e3:.1f} us (eager {row['eager_ms'] * 1e3:.1f}), plain "
                  f"{row['plain_ms'] * 1e3:.1f} us, {lib}, bound {row['bound_ms'] * 1e3:.2f} us "
                  f"({row['bound_by']})", flush=True)
        if abs(bias) > bias_limit:
            fail(f"stochastic rounding biased at {label}: mean error {bias} > {bias_limit}")
    return rows


def phase_fixed_grouped(torch, quant, draw_seed):
    """The grouped fixed-point launch over the flagship's 72 PTQ tensors
    (``QUANT_TENSORS``) against the grouped plain version bit for bit, one
    launch each, in every format x symmetric x clamp x rounding; then at wl
    8, fl 4, clamp, per rounding: the grouped launch (graph replay and
    eager), the 72 single-tensor launches the per-tensor route makes, the
    plain version, and two yardsticks (72 ``fake_quantize`` calls, and one
    over a flat buffer of the same elements, made outside the timing)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    tensors = [_fixed_input(torch, n, gen) for _, n, count in QUANT_TENSORS for _ in range(count)]
    elements = sum(x.numel() for x in tensors)
    checks = 0
    for wl, fl in FIXED_FORMATS:
        for symmetric in (False, True):
            for clamp in (True, False):
                for stochastic in (False, True):
                    kw = dict(clamp=clamp, symmetric=symmetric, stochastic=stochastic,
                              seed=draw_seed(gen, "cuda") if stochastic else None)
                    before = quant.fused_fixed_point_quantize.launches
                    got = quant.fused_fixed_point_quantize_grouped(tensors, wl, fl, **kw)
                    torch.cuda.synchronize()
                    launches = quant.fused_fixed_point_quantize.launches - before
                    want = quant.fixed_point_quantize_grouped_reference(tensors, wl, fl, **kw)
                    if launches != 1 or not all(torch.equal(a, b) for a, b in zip(got, want)):
                        fail(f"grouped fixed-point kernel ({launches} launches) differs from its "
                             f"plain version at wl {wl} fl {fl} symmetric {symmetric} clamp "
                             f"{clamp} stochastic {stochastic}")
                    checks += 1
    qmin, qmax = -(2 ** (PTQ_WL - 1)), 2 ** (PTQ_WL - 1) - 1
    flat = torch.cat([x.reshape(-1) for x in tensors])

    def library():
        return [torch.fake_quantize_per_tensor_affine(x, 2.0 ** -PTQ_FL, 0, qmin, qmax)
                for x in tensors]

    def library_flat():
        return torch.fake_quantize_per_tensor_affine(flat, 2.0 ** -PTQ_FL, 0, qmin, qmax)
    rows = []
    for stochastic in (False, True):
        kw = dict(stochastic=stochastic, seed=draw_seed(gen, "cuda") if stochastic else None)

        def grouped():
            return quant.fused_fixed_point_quantize_grouped(tensors, PTQ_WL, PTQ_FL, **kw)

        def per_tensor():
            return [quant.fused_fixed_point_quantize(x, PTQ_WL, PTQ_FL, **kw) for x in tensors]
        row = dict(size=f"{len(tensors)} tensors", elements=elements, tensors=len(tensors),
                   per_quantisation=1, wl=PTQ_WL, fl=PTQ_FL,
                   rounding="stochastic" if stochastic else "nearest", max_abs_err=0.0,
                   ms=time_ms(torch, grouped), eager_ms=eager_ms(torch, grouped),
                   per_tensor_ms=time_ms(torch, per_tensor, inner=5),
                   per_tensor_eager_ms=eager_ms(torch, per_tensor, inner=5),
                   plain_ms=time_ms(torch, lambda: quant.fixed_point_quantize_grouped_reference(
                       tensors, PTQ_WL, PTQ_FL, **kw), reps=5, inner=3),
                   library_ms=None if stochastic else time_ms(torch, library, inner=5),
                   library_flat_ms=None if stochastic else time_ms(torch, library_flat),
                   **_bound(8 * elements, 4 * elements, "float32"))
        rows.append(row)
        lib = ("" if stochastic else f", fake_quantize x {len(tensors)} "
               f"{row['library_ms'] * 1e3:.1f} us, one flat fake_quantize "
               f"{row['library_flat_ms'] * 1e3:.1f} us")
        print(f"quant fixed grouped {len(tensors)} tensors ({elements:,} elements) "
              f"{row['rounding']:10s} wl {PTQ_WL} fl {PTQ_FL}: kernel = plain bit for bit, one "
              f"launch ({checks} settings) | grouped {row['ms'] * 1e3:.1f} us (eager "
              f"{row['eager_ms'] * 1e3:.1f}), {len(tensors)} single launches "
              f"{row['per_tensor_ms'] * 1e3:.1f} us (eager "
              f"{row['per_tensor_eager_ms'] * 1e3:.1f}), "
              f"plain {row['plain_ms'] * 1e3:.1f} us{lib}, bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']})", flush=True)
    return rows


def _codebooks(cbm):
    books = [(f"lsq_fibbinary({n})", cbm.lsq_fibbinary_codebook(n)) for n in range(4, 12)]
    return books + [("fibbinary(8, 4)", cbm.fibbinary_codebook(8, 4)),
                    ("fibonacci(8, 4)", cbm.fibonacci_sequence_codebook(8, 4))]


def _codeword_input(torch, np, n, cb, gen):
    """Values over the codebook's range and 20% beyond on each side, with
    every codeword, every midpoint of two neighbours (a tie) and +-0 first."""
    s = np.unique(cb)
    span = s[-1] - s[0]
    x = (s[0] - 0.2 * span) + torch.rand(n, generator=gen, device="cuda") * (1.4 * span)
    special = torch.tensor(np.concatenate([[0.0, -0.0], s, (s[1:] + s[:-1]) / 2]),
                           dtype=torch.float32, device="cuda")
    k = min(n, special.numel())
    x[:k] = special[:k]
    return x


def phase_codeword_kernel(torch, quant, cbm):
    """The nearest-codeword kernel against its plain version, bit for bit,
    for every codebook at the LSQ path's sizes and 2^20 elements (and 2^24
    for the largest codebook); kernel, plain and ``torch.bucketize`` on the
    midpoints plus an index (yardstick) times for the LSQ path's 67-entry
    codebook at its sizes and for 2^24 x 287."""
    import numpy as np

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, cb_np in _codebooks(cbm):
        cb = torch.tensor(cb_np, dtype=torch.float32, device="cuda")
        big = [CODEWORD_BIG[1]] if name == CODEWORD_BIG[0] else []
        for label, n, count in CODEWORD_SIZES + big:
            x = _codeword_input(torch, np, n, cb_np, gen)
            got = quant.fused_nearest_codeword(x, cb)
            torch.cuda.synchronize()
            if not torch.equal(got, quant.nearest_codeword_reference(x, cb)):
                fail(f"nearest-codeword kernel differs from its plain version: {name} at {label}")
            timed = (count and name == f"lsq_fibbinary({LSQ_NBITS})") or (label, n, count) in big
            if not timed:
                print(f"codeword {name:18s} ({cb.numel():3d} entries) {label:8s}: kernel = plain "
                      f"bit for bit", flush=True)
                continue
            srt = torch.sort(cb).values
            mids = (srt[1:] + srt[:-1]) / 2

            def library():  # right=False: a tie goes to the lower codeword
                return srt[torch.bucketize(x, mids, right=False)]

            def kernel():
                return quant.fused_nearest_codeword(x, cb)
            row = dict(codebook=name, entries=cb.numel(), size=label, elements=n,
                       per_forward=count, max_abs_err=0.0, ms=time_ms(torch, kernel),
                       eager_ms=eager_ms(torch, kernel),
                       plain_ms=time_ms(torch, lambda: quant.nearest_codeword_reference(x, cb),
                                        **(dict(reps=3, inner=1) if count == 0 else {})),
                       library_ms=time_ms(torch, library),
                       library_equal=torch.equal(library(), got),
                       **_bound(8 * n + 4 * cb.numel(), 2 * n * cb.numel(), "float32"))
            rows.append(row)
            print(f"codeword {name:18s} ({cb.numel():3d} entries) {label:8s}: kernel = plain bit "
                  f"for bit | kernel {row['ms'] * 1e3:.1f} us (eager {row['eager_ms'] * 1e3:.1f}), "
                  f"plain {row['plain_ms'] * 1e3:.1f} us, bucketize "
                  f"{row['library_ms'] * 1e3:.1f} us "
                  f"({'equal' if row['library_equal'] else 'differs'}), bound "
                  f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})", flush=True)
    return rows


def _lsq_weight(torch, np, shape, cb, gen):
    """Normal weights at LSQ_STEP, sigma 0.6 times the codebook ``cb``'s
    largest entry (some past Qn and Qp after the division), with every
    codeword, every tie between two neighbours, +-0, NaN and +-1e3 first."""
    w = (torch.randn(shape, generator=gen, device="cuda") * cb[-1] * LSQ_STEP * 0.6).reshape(-1)
    special = np.concatenate([cb, (cb[1:] + cb[:-1]) / 2]) * LSQ_STEP
    special = np.concatenate([special, [0.0, -0.0, np.nan, 1e3, -1e3]])
    w[:special.size] = torch.tensor(special, dtype=torch.float32, device="cuda")
    return w.view(shape)


def phase_lsq_codeword(torch, quant, lsq, cbm):
    """The codeword kernel's LSQ mode against the eager chain's values (its
    plain version), compared as bits (NaN included), at the flagship's layer
    shapes, nbits 4 to 11 and two step sizes (LSQ_STEP, whose ties are
    exact, and 1.37 times it); then at nbits LSQ_NBITS the LSQ mode, the
    plain snap mode on the clamped values and the eager chain
    (``lsq._lsq_chain``: ~10 launches, the snap by the kernel) timed per
    shape. No single PyTorch call computes the chain: no library time."""
    import numpy as np

    rows, checks = [], 0
    gen = torch.Generator(device="cuda").manual_seed(6)

    def bits(t):
        return t.contiguous().view(torch.int32)

    for nbits in range(4, 12):
        cb_np = np.asarray(cbm.lsq_fibbinary_codebook(nbits))
        cb = torch.tensor(cb_np, dtype=torch.float32, device="cuda")
        for label, shape, count in LSQ_SHAPES:
            w = _lsq_weight(torch, np, shape, cb_np, gen)
            qn, qp, g = lsq._lsq_bounds(w, nbits)
            for step_value in (LSQ_STEP, LSQ_STEP * 1.37):
                step = torch.tensor(step_value, device="cuda")
                got = quant.fused_lsq_codeword(w, step, cb, g, qn, qp)
                torch.cuda.synchronize()
                if not torch.equal(bits(got), bits(quant.lsq_codeword_reference(
                        w, step, cb, g, qn, qp))):
                    fail(f"LSQ mode differs from the eager chain: nbits {nbits} at {label}, "
                         f"step {step_value}")
                checks += 1
            if nbits != LSQ_NBITS:
                continue
            snap_in = torch.clamp(w / step, qn, qp)

            def kernel():
                return quant.fused_lsq_codeword(w, step, cb, g, qn, qp)
            n = w.numel()
            row = dict(codebook=f"lsq_fibbinary({nbits})", entries=cb.numel(), size=label,
                       elements=n, per_forward=count, max_abs_err=0.0,
                       ms=time_ms(torch, kernel), eager_ms=eager_ms(torch, kernel),
                       plain_ms=time_ms(torch, lambda: quant.lsq_codeword_reference(
                           w, step, cb, g, qn, qp)),
                       snap_ms=time_ms(torch, lambda: quant.fused_nearest_codeword(snap_in, cb)),
                       chain_ms=time_ms(torch, lambda: lsq._lsq_chain(w, step, nbits, cb)),
                       chain_eager_ms=eager_ms(torch, lambda: lsq._lsq_chain(w, step, nbits, cb)),
                       library_ms=None,
                       **_bound(8 * n + 4 * cb.numel() + 4, 2 * n * cb.numel() + 7 * n,
                                "float32"))
            rows.append(row)
            print(f"codeword lsq mode nbits {nbits} {label:8s}: kernel = eager chain bit for bit "
                  f"({checks} settings so far) | kernel {row['ms'] * 1e3:.1f} us (eager "
                  f"{row['eager_ms'] * 1e3:.1f}), snap mode {row['snap_ms'] * 1e3:.1f} us, eager "
                  f"chain {row['chain_ms'] * 1e3:.1f} us (eager {row['chain_eager_ms'] * 1e3:.1f}), "
                  f"plain {row['plain_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.2f} us "
                  f"({row['bound_by']})", flush=True)
    print(f"codeword lsq mode: {checks} settings (nbits 4-11 x {len(LSQ_SHAPES)} shapes x 2 "
          f"steps) equal to the eager chain bit for bit", flush=True)
    return rows


def phase_ptq_path(torch, wrappers, card):
    """Post-training quantization at the flagship (``experiments/ptq_sweep.py:94-110``
    in the package): the FP32 weights quantized by ``apply_weight_quant``
    with one ``FixedPointWeightQuant`` (one grouped kernel launch), loaded
    into a copy of the model, ``eval_chunk`` through the bd kernel; nearest
    and stochastic, each against the plain path (the grouped plain version
    with the group's one seed) bit for bit; the time of a whole 24-point
    sweep (quantize only), grouped and through per-tensor closures in
    turns; eval samples/s."""
    import copy

    from channelestimationtransformer_torch.ops.cuda.bd_attention import draw_seed
    from channelestimationtransformer_torch.ops.cuda.quant import (
        fixed_point_quantize_grouped_reference,
    )
    from channelestimationtransformer_torch.ops.quant import (
        FixedPointWeightQuant,
        apply_weight_quant,
        build_weight_quant_settings,
        fixed_point_quantize,
    )
    from channelestimationtransformer_torch.train.trainer import eval_chunk

    cfg, model, _, ds = _models_and_data(torch)
    sd = model.state_dict()
    n_batches, batch = 8, 256

    def settings(wl, fl, rounding):
        return build_weight_quant_settings(sd, FixedPointWeightQuant(wl, fl, rounding))

    def closure_settings(wl, fl, rounding):
        return build_weight_quant_settings(sd, lambda w, percentage, generator: (
            fixed_point_quantize(w, wl, fl, rounding=rounding, generator=generator)))

    def quantise(s, seed=0):
        return apply_weight_quant(sd, s, generator=torch.Generator(device="cuda").manual_seed(seed))

    def plain(s, wl, fl, rounding, seed=0):
        names = sorted(s.settings)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        key = draw_seed(gen, "cuda") if rounding == "stochastic" else None
        return dict(sd) | dict(zip(names, fixed_point_quantize_grouped_reference(
            [sd[k] for k in names], wl, fl, stochastic=key is not None, seed=key)))

    def run(m, seed):
        return eval_chunk(m, ds, num_batches=n_batches, batch_size=batch, label_len=cfg.label_len,
                          generator=torch.Generator(device="cuda").manual_seed(seed))

    fp32_sum = sum(v.double().abs().sum().item() for v in sd.values() if v.is_floating_point())
    fp32_nmse = run(model, 1)["nmse"].item()
    qmodel = copy.deepcopy(model)
    out = {"fp32_nmse": fp32_nmse}
    for rounding in ("nearest", "stochastic"):
        s = settings(PTQ_WL, PTQ_FL, rounding)
        elements = sum(sd[k].numel() for k in s.settings)
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        q = quantise(s)
        qmodel.load_state_dict(q)
        res = run(qmodel, 1)
        torch.cuda.synchronize()
        launches = _counts(wrappers)
        expected = {k: 0 for k in launches} | dict(fixed=1, bd_fwd=13 * n_batches)
        want = plain(s, PTQ_WL, PTQ_FL, rounding)
        equal = all(torch.equal(q[k], want[k]) for k in sd)
        nmse = res["nmse"].item()
        print(f"ptq eval path, {rounding} wl {PTQ_WL} fl {PTQ_FL}: {len(s)} tensors, "
              f"{elements:,} elements, launches {_launch_report(launches, expected)}; quantized "
              f"tensors {'equal to' if equal else 'DIFFER from'} the plain path's bit for bit; "
              f"eval_chunk {n_batches} x {batch}: nmse {nmse:.6f} (fp32 {fp32_nmse:.6f})",
              flush=True)
        if launches != expected or len(s) != 72:
            fail(f"kernels launched {launches} times on the ptq eval path, not {expected}")
        if not equal:
            fail(f"ptq {rounding}: quantized tensors differ from the plain path's")
        if not math.isfinite(nmse):
            fail("non-finite NMSE on the ptq eval path")
        out[rounding] = dict(launches=launches, nmse=nmse, tensors=len(s), elements=elements)
    if sum(v.double().abs().sum().item() for v in sd.values() if v.is_floating_point()) != fp32_sum:
        fail("the ptq path changed the FP32 weights")

    sweeps = {"grouped": [settings(*point) for point in SWEEP],
              "per-tensor": [closure_settings(*point) for point in SWEEP]}

    def sweep(name, _):
        for i, s in enumerate(sweeps[name]):
            quantise(s, i)
    sweep_times = _alternate(torch, sweep, rounds=10, names=tuple(sweeps))  # two warm up each
    sweep_ms = {name: statistics.median(ts[2:]) * 1e3 for name, ts in sweep_times.items()}
    print(f"ptq sweep: {len(SWEEP)} points (wl 4-15, fl = wl - 4, nearest and stochastic), "
          f"{72 * len(SWEEP):,} tensors: {sweep_ms['grouped']:.3f} ms per sweep grouped (one "
          f"launch a point), {sweep_ms['per-tensor']:.3f} ms through per-tensor closures (72 "
          f"launches a point), in turns, quantize only (median of "
          f"{len(sweep_times['grouped']) - 2}) on {card}", flush=True)

    models = {"ptq": qmodel, "fp32": model}
    times = _alternate(torch, lambda name, i: run(models[name], 100 + i), names=tuple(models))
    for name, ts in times.items():
        med = statistics.median(ts[2:])
        out[f"{name}_samples_per_s"] = n_batches * batch / med
        print(f"ptq eval {name:4s} weights: {n_batches * batch / med:.1f} samples/s (median of "
              f"{len(ts) - 2} chunks of {n_batches * batch}, {med * 1e3:.3f} ms) on {card}",
              flush=True)
    return dict(out, sweep_ms=sweep_ms["grouped"], sweep_per_tensor_ms=sweep_ms["per-tensor"],
                sweep_s_all=sweep_times)


def _per_path(rows, key, weight):
    """Sum of ``key`` weighted by each row's count on the path (``weight``)."""
    return sum(r[key] * r[weight] for r in rows if r[weight])


def _kernel_entry(name, replaces, launches, rows, weight, per):
    tpu = "channelestimationtransformer_tpu/ops/pallas/"
    return {
        "name": name,
        "route": "cuda",
        "source": f"channelestimationtransformer_torch/ops/cuda/csrc/{name}.cu",
        "replaces": ", ".join(tpu + r for r in replaces),
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r[weight]),
        "ms": _per_path(rows, "ms", weight),
        "plain_ms": _per_path(rows, "plain_ms", weight),
        "bound_ms": _per_path(rows, "bound_ms", weight),
        "bound_by": ("bytes" if _per_path(rows, "bytes_ms", weight)
                     >= _per_path(rows, "ops_ms", weight) else "operations"),
        "library_ms": (None if any(r["library_ms"] is None for r in rows if r[weight])
                       else _per_path(rows, "library_ms", weight)),
        "per": per,
    }


def main(argv):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build
    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import mha_attention as mha
    from channelestimationtransformer_torch.ops.cuda import quant
    from channelestimationtransformer_torch.ops.quant import codebooks, lsq
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
    libs = (ops.FWD_LIB, ops.BWD_LIB, mha.LIB, quant.FIXED_LIB, quant.CODEWORD_LIB)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        builds = list(pool.map(_build.build, libs))
    build_s = time.perf_counter() - t0
    build_info = {}
    for name, (lib, log) in zip(libs, builds):
        (OUT / f"ptxas_{name}.txt").write_text(log)
        info = build_info[name] = dict(**_ptxas_summary(log), hmma=_hmma_count(lib))
        print(f"build: {lib.name} ({build_s:.2f} s for all {len(libs)}): "
              f"{info['kernels']} kernels, registers {info['registers_min']}-"
              f"{info['registers_max']}, spill stores {info['spill_stores']} bytes, spill "
              f"loads {info['spill_loads']} bytes, static shared memory up to "
              f"{info['smem_max']} bytes (ptxas -v); SASS: {info['hmma']} HMMA", flush=True)
        if name in TENSOR_CORE_LIBS and (info["hmma"] == 0 or info["spill_stores"]
                                         or info["spill_loads"]):
            fail(f"{name}: a tensor-core library with {info['hmma']} HMMA and "
                 f"{info['spill_stores'] + info['spill_loads']} bytes spilled")

    # Bring the card's clocks up before the first timed row.
    x = torch.randn(4096, 4096, device="cuda")
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()

    profile = "--profile" in argv
    wrappers = dict(bd_fwd=ops.bd_attention_fwd, bd_bwd=ops.bd_attention_bwd,
                    mha=mha.mha_attention_fwd, fixed=quant.fused_fixed_point_quantize,
                    codeword=quant.fused_nearest_codeword)
    eval_rows = phase_kernel(torch, F, ops.bd_attention, ops.bd_attention_reference,
                             [s + (B, H, E, E) for s in SHAPES])
    mha_rows = phase_kernel(torch, F, mha.mha_attention, mha.mha_attention_reference,
                            [s + (XL_B, XL_H, XL_E, XL_E) for s in XL_SHAPES]
                            + MHA_EXTRA_SHAPES, prefix="mha kernel", seed=2)
    fixed_rows = phase_fixed_kernel(torch, quant, ops.draw_seed)
    grouped_rows = phase_fixed_grouped(torch, quant, ops.draw_seed)
    codeword_rows = phase_codeword_kernel(torch, quant, codebooks)
    lsq_rows = phase_lsq_codeword(torch, quant, lsq, codebooks)
    fwd_rows, bwd_rows = phase_kernel_train(torch, F, ops)
    eval_path = phase_eval_path(torch, wrappers, card, profile)
    xl_cfg = InformerConfig(d_model=1024, d_ff=4096, seq_len=256, use_pallas=True)
    xl_eval_path = phase_eval_path(torch, wrappers, card, profile, name="xl eval path",
                                   cfg=xl_cfg, samples=4096, slots=xl_cfg.seq_len + 10,
                                   batch=64, expected={"mha": 13 * 8})
    ptq_path = phase_ptq_path(torch, wrappers, card)
    from channelestimationtransformer_torch.models.informer import build_informer

    lsq_cfg = InformerConfig(attn="full", use_pallas=True, lsq_nbits=LSQ_NBITS,
                             lsq_fibbinary=True)
    lsq_path = phase_eval_path(
        torch, wrappers, card, profile, name="lsq-fibbinary eval path", cfg=lsq_cfg,
        expected={"bd_fwd": 13 * 8, "codeword": 72 * 8},
        beside={"fp32-kernel": build_informer(InformerConfig(use_pallas=True), device="cuda",
                                              seed=0)})
    train_path = phase_train_path(torch, wrappers, card, profile)

    f32 = lambda rows: [r for r in rows if r["dtype"] == "float32"]  # noqa: E731
    kernels = [
        _kernel_entry("bd_attention_fwd", ["bd_attention.py:121"], train_path["launches_fwd"],
                      f32(fwd_rows), "calls_per_step", "one training step: the 13 float32 calls "
                      "at their flagship shapes (dropout 0.05)"),
        _kernel_entry("bd_attention_bwd", ["bd_attention.py:153"], train_path["launches_bwd"],
                      f32(bwd_rows), "calls_per_step", "one training step: the 13 float32 calls "
                      "at their flagship shapes (dropout 0.05)"),
        _kernel_entry("mha_attention_fwd", ["attention.py:70", "attention.py:31"],
                      xl_eval_path["launches"]["mha"], f32(mha_rows), "calls_per_batch",
                      "one xl eval batch: the 13 float32 calls at their xl shapes "
                      "(B 64, H 8, E 128)"),
        _kernel_entry("fixed_point_quantize", ["quant.py:38"],
                      ptq_path["nearest"]["launches"]["fixed"],
                      [r for r in grouped_rows if r["rounding"] == "nearest"], "per_quantisation",
                      f"one PTQ quantization: the 72 tensors at wl {PTQ_WL}, fl {PTQ_FL}, nearest, "
                      f"in one grouped launch"),
        _kernel_entry("nearest_codeword", ["quant.py:107"], lsq_path["launches"]["codeword"],
                      lsq_rows, "per_forward", f"one LSQ-fibbinary forward: the 72 layers' "
                      f"LSQ mode (the lsq_quantize chain and the snap to the "
                      f"{len(codebooks.lsq_fibbinary_codebook(LSQ_NBITS))}-entry codebook, one "
                      f"launch each)"),
    ]
    kernels[3].update(per_tensor_ms=grouped_rows[0]["per_tensor_ms"],
                      library_flat_ms=grouped_rows[0]["library_flat_ms"])
    kernels[4].update(snap_mode_ms=_per_path(lsq_rows, "snap_ms", "per_forward"),
                      eager_chain_ms=_per_path(lsq_rows, "chain_ms", "per_forward"))
    kernels[0].update(eval_launches=eval_path["launches"]["bd_fwd"],
                      eval_ms=_per_path(f32(eval_rows), "ms", "calls_per_batch"),
                      eval_bound_ms=_per_path(f32(eval_rows), "bound_ms", "calls_per_batch"),
                      eval_library_ms=_per_path(f32(eval_rows), "library_ms", "calls_per_batch"))
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, build_info=build_info, kernel_rows=eval_rows,
        mha_kernel_rows=mha_rows, fixed_rows=fixed_rows, fixed_grouped_rows=grouped_rows,
        codeword_rows=codeword_rows,
        lsq_codeword_rows=lsq_rows, train_fwd_rows=fwd_rows,
        train_bwd_rows=bwd_rows, eval_path=eval_path, xl_eval_path=xl_eval_path,
        ptq_path=ptq_path, lsq_path=lsq_path, train_path=train_path, kernels=kernels), indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
