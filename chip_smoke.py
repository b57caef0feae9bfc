"""Drive the PyTorch port's serving, quantized serving and training paths
on one NVIDIA card, in float32, bfloat16 and float16 activations, its channel
generator and training drivers, ProbSparse attention, fused QKV projections,
LSQ training, the quantization study (QAT, pruning and their drivers), int8
serving, blockwise streaming and the baseline models with their drivers,
the end-to-end link simulation with its drivers, the scale demo with its
int8 A/B, the utilities (tracing, timing, memory, complexity, the native
host library) with the analysis drivers, the calibration and profiling
drivers, data-parallel training, ring attention (eval and training) and
tensor parallelism over NCCL, the two-axis (data x model) mesh, and the
multi-chip dry run (``cli/multichip.py``).

    python3 chip_smoke.py            # the check, as run on the card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of the eval and training paths
    python3 chip_smoke.py --conv     # phase 1, then the circular convolution's kernels alone

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and convs,
   and cuBLAS's bf16 and fp16 reduced-precision reductions off (16-bit GEMMs
   accumulate in f32, as the JAX package's dots);
2. build: the six CUDA kernel libraries, compiled in parallel with nvcc
   from the sources here; per library its kernels' registers, spill bytes
   and static shared memory from ``-Xptxas -v`` (the full logs go beside
   ``chip_smoke.json``, as ``ptxas_<name>.txt``) and its count of
   tensor-core MMA instructions in the SASS (mma.sync's HMMA and wgmma's
   HGMMA); the three attention libraries must show MMAs and no spills, and
   for each of them a line per dtype gives its instances' registers, spills
   and MMAs by operand type: every bf16 instance must issue bf16 MMAs only,
   every f32 one TF32 only, every f16 one f16 only (``HMMA.16816.F32``,
   ``HGMMA...F32``: no operand suffix), and the mha library's wgmma
   instances HGMMA,
   each on a line of its own (per-instance rows in ``chip_smoke.json``);
3. kernel, eval: the bd-attention forward kernel (dropout 0) against its
   plain version at the six flagship shape classes in float32, bfloat16 and
   float16,
   with kernel, plain and ``F.scaled_dot_product_attention`` (yardstick
   only) times;
4. kernel, xl eval: the mha-attention forward kernel against its plain
   version at the six shape classes of the xl model (B 64, H 8, E 128) and
   two shapes beyond the model (D != E; a long non-square causal shape), in
   float32, bfloat16 and float16, timed likewise; each row names its route
   ("wgmma": bf16 or f16 at Lq > 32, E and D 64 or 128; "mma" the rest),
   checks that its
   launch counted on that route, and gives the launch's registers and
   blocks an SM (``mha_attention_fwd_occupancy``);
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
   its bound and the SDPA yardstick, with the launch's registers and blocks
   resident on an SM (the libraries' ``<name>_occupancy`` entries); then
   the checks of 3, 4 and 7 (the
   kernels' own times alone) at the scale demo's and the int8 A/B's shapes
   that those lists leave out (``scale_kernel_shapes``: the bd kernels at
   E 32 and 64, mha at L 256, E 64, its rows timed beside SDPA with their
   routes as in 4), so that every kernel instance the scale phases launch
   is held against its plain version; then the circular convolution's
   kernels (forward, data gradient, weight and bias gradient) against
   their plain versions at the flagship's seven convolutions of a training
   step at batch 1024 (``CONV_SHAPES``), two runs bit for bit, each timed
   beside its bound, its plain version and cuDNN (``F.conv1d`` on the
   padded input and its ``convolution_backward``, TF32 off); ``--conv``
   runs this alone after 1 and its own build;
8. eval path: ``build_informer(InformerConfig(use_pallas=True))`` at full
   width and ``eval_chunk`` over 8 batches of 256 from a 65,536-sample
   dataset resident on the card, with the kernels' launch counts (all 104
   attention calls through the bd forward kernel, the 56 circular
   convolutions through the conv kernel; every later phase counts the conv
   kernels too, ``_conv_launches``), NMSE, a comparison with
   the plain attention path on one batch, the model's parameters and FLOPs
   per batch, and steady-state eval samples/s and TFLOP/s;
9. xl eval path: the same at the xl width (d_model 1024, d_ff 4096, seq_len
   256; ``experiments/scale_demo.py``'s "xl" row), 8 batches of 64 from a
   4,096 x 266 x 16 dataset: all 104 attention calls through the mha
   kernel (its mma route), none through the bd kernels;
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
   compared loss, output and gradient by gradient (max pooling routed as
   the kernel path's); ``train_chunk`` with the
   kernels' launch counts and a finite loss; steady-state training
   samples/s of both paths;
13. bf16 eval path: ``InformerConfig(use_pallas=True, dtype="bfloat16")``
   (``bench.py``'s config) as in 8: 104 bd launches, one batch against the
   bf16 plain path (``BF16_TOL``), the NMSE of its prediction against its
   f32 twin's (same weights and batch) with cuBLAS's bf16 reductions off
   and on, eval samples/s in turns with the twin;
14. bf16 xl eval path: the xl row in bf16 (``scale_demo.py``'s default
   dtype) as in 9: 104 mha launches, 40 on the wgmma route (L 256, 128
   and 64) and 64 on mma, no bd launch, the same checks;
15. bf16 lsq-fibbinary eval batch: one batch of the model of 11 in bf16
   (72 codeword and 13 bd launches) against its plain path;
16. bf16 training path: 12 in bf16: the step through the kernels against
   the plain path and both against the f32 twin's gradients
   (``BF16_GRAD_*``; max pooling routed as the kernel path's in both), 104
   forward and 104 backward launches, parameters and Adam state f32,
   training samples/s in turns with the twin; then the bd kernels' f32 and
   bf16 instances side by side, a training step of each: graph-replay and
   eager us, bound, launches, and per shape registers and blocks an SM;
16a. float16: 13-16 in float16 (``F16_TOL``, ``F16_GRAD_*``; the xl path
   at ``F16_MHA_TOL``, where the plain path's attention over E 128 runs in
   f16): the flagship eval path (104 bd launches), the xl eval path (40
   wgmma, 64 mma), one LSQ-fibbinary batch and the training path (104 + 104;
   the f16 instances' step beside the others'). The kernel phases 3, 4, 10,
   11 and the scale rows hold the f16 instances too, and the training rows
   also hold the f16 backward at a training step's cotangents (dO times
   2^-17: dS below f16's normal range unless the kernel scales it), relative
   to each gradient's max;
17. datagen: ``generate_beamformed_dataset`` (CDL-B 64 x 2, 100 slots, one
   chunk of 128 samples) on the card against the CPU from the same draws
   (``DATAGEN_TOL``, the kept beams equal); the parity recipe's data on the
   card (``CDLModel.calibrated(5.0)``, 16,384 + 2,048 samples) with its
   seconds, samples/s, peak memory, per-(sample, rx, beam) mean and N - 1
   variance, four distinct beams a sample and the lag correlation curve of
   ``experiments/calibrate_channel.py``; a reference pickle round trip
   (``save_reference_format`` -> ``WindowDataset.from_pickle``) bit for bit;
18. cli: ``cli.train_informer.main`` in this process on a short recipe
   (``CLI_ARGS``: SNR 20, calibrated 5 km/h, 2 epochs of 20 steps, 1,024 +
   512 samples, the kernels on), with the bd launch counts (13 a step
   forward and backward, 13 a validation batch), finite losses and the
   result JSON written;
19. prob eval path: ``InformerConfig(use_pallas=True, attn="prob")`` as in
   8: ProbSparse attention in the encoder and the decoder's self-attention
   (torch ops), the 3 cross-attention calls a batch on the bd forward (24
   in 8 batches, no mha), one batch against the plain path from the same
   generator seed (the same ``index_sample`` draws), eval samples/s in
   turns with the full-attention flagship;
20. prob training path: 12 for that model: one step through the kernels
   against the plain path (the same draws and dropout masks), 24 forward
   and 24 backward launches in 8 steps, training samples/s in turns with
   the full flagship, beside the reference's A100 figure (2,230);
21. fused path: ``InformerConfig(use_pallas=True, fuse_qkv=True)`` as in 8
   (104 launches) and 12, each in turns with the unfused model carrying
   its weights (the query, key and value kernels stacked are the fused
   ones), and one eval batch and one training step against that model;
22. lsq train: ``cli.train_lsq.main`` in this process (``LSQ_TRAIN_ARGS``:
   LSQ-fibbinary, nbits 8, 2 epochs of 20 steps, 1,024 samples, the kernels
   on) from phase 18's checkpoint: the preload, the launch counts (72
   LSQ-mode and 72 snap-mode codeword launches and 13 bd forward and
   backward a step; 72 LSQ-mode and 13 bd forward a validation batch),
   finite losses, the results JSON; then 12 for the LSQ-fibbinary model:
   one step through the kernels against the plain path (the snap's plain
   version, plain attention), ``step_size`` gradients included, 104 + 104
   bd and 1,152 codeword launches in 8 steps, samples/s of both paths;
23. qat step: the flagship (kernels on) after one training step, its 72
   attention and FFN weights through ``FixedPointPartialWeightQuant`` and
   then ``FibbinaryPartialWeightQuant`` (proximal, wl 2, fl -2, fraction
   0.7: ``experiments/qat_incremental.py``'s defaults) by
   ``apply_weight_quant`` and ``assign_``: one fixed-point (codeword)
   launch for all 72, the tensors bit for bit with a per-tensor plain path
   written out here (the plain snap, ``torch.sort``, the select and the
   clamp), at least the fraction on the grid, the parameters and Adam's
   moments the same objects with the same values; 8-step chunks of QAT
   (train step, then the transform) with 13 + 13 bd and one fixed-point or
   codeword launch a step;
24. prune step: 8-step chunks of pruning (train step, then ``apply_pruning``
   at 0.9; 13 + 13 bd launches a step), the QAT, prune and plain FP32
   chunks' samples/s in turns; ``apply_pruning`` at 0.5 and 0.9 on the card
   against the CPU (masks and values bit for bit) and ``measured_sparsity``
   equal to what the block count gives (blocks tied at a threshold pruned
   with it);
25. drivers: ``cli.ptq_sweep`` (wl 8-10, 512 samples), ``cli.qat_incremental``
   (fibbinary, one epoch of 10 steps a fraction, 1,024 samples) and
   ``cli.prune`` (2 epochs of 10 steps) in this process from phase 18's
   checkpoint, the kernels on: their launch counts, finite validation NMSEs
   and files;
26. int8 eval path: the flagship (kernels on, seed 0) served by
   ``ops/quant/serving.py``: its 77-entry int8 table built on the card
   equal to the CPU's bit for bit; ``eval_chunk`` of 8 x 256 in f32, W8A8
   and weight-only (in ``serving_intercept``) with 77 entries hit, 104 bd
   launches each and 616 GEMMs a served chunk (``torch._int_mm`` in W8A8,
   ``torch.mm(..., out_dtype=float32)`` of bf16 in weight-only); one layer
   of each GEMM shape against the CPU (W8A8's GEMM and output bit for bit,
   weight-only within ``INT8_LAYER_TOL``); one batch against the plain attention
   path inside the intercept and against the same model served on the CPU
   (an NMSE limit a mode, ``INT8_VS_PLAIN_NMSE``); samples/s of the three
   modes in turns;
27. streaming path: ``streaming_rollout`` of the flagship over 128 streams
   of 100 slots in blocks of 5 (20 blocks, 260 bd launches), every block's
   prediction against the plain path's rollout (``MAIN_TOL``), the last
   one against the offline forward of its window (``STREAM_TOL``), blocks/s
   of the kernel and plain paths in turns;
28. baselines: ``TransformerConfig()`` eval and training chunks (8 x 256),
   and lstm, gru and rnn (``cli/comparison.py``'s sizes) in 8 Adam steps x
   64 and a 5-step rollout x 256, each against the same model on the CPU on
   one batch (``BASELINE_TOL``), with samples/s;
29. the comparison's Informer (``InformerConfig(seq_len=25, label_len=10,
   pred_len=5)``, kernels on: encoder lengths 25 / 13 / 7 / 4 and 12 / 6 /
   3, a 15 x 7 cross-attention): one eval batch and one training step
   against the plain path (as phases 8 and 12 hold the flagship), its 8-step
   chunks in turns;
30. their drivers: ``cli.int8_serving`` and ``cli.train_streaming`` from
   phase 18's checkpoint and ``cli.comparison`` cut to a few steps, 1,024
   samples and two SNRs: their launch counts, finite results and files.
31. link: ``sim/``'s ``simulate_ber`` and ``simulate_coded_ber`` on the card
   against the CPU in the e2e driver's five variants (uncoded, LS CSI, time
   domain, conv, LDPC) at its eight Eb/N0 points on 256 channels, the same
   draws injected on both: uncoded BER (``LINK_BER_TOL``), the decoders'
   LLRs (``LINK_LLR_TOL``), the Viterbi and LDPC decoders on identical LLRs
   (``LINK_BITS_TOL``), SE (``LINK_SE_TOL``), the card's seconds and bits/s;
32. e2e drivers: ``cli.end_to_end_sim`` in the five variants of
   ``experiments/round2_queue.sh:30-38`` at its defaults from phase 18's
   checkpoint (13 bd forward launches a run, no other kernel), finite rows,
   files, seconds and Monte-Carlo bits/s; ``cli.collect_e2e`` merges them;
33. scale demo: ``cli.scale_demo`` at its six sizes in bf16, steps cut: the
   parameters against JAX's column, bd forward and backward launches against
   the routing's counts (``attention_calls``), FLOPs a step and the share of
   the card's peak;
34. int8 A/B: ``cli.int8_scale_ab`` at its four sizes, repetitions cut: bd,
   mha (by route) and GEMM launches against the routing's counts, finite
   timings.
35. analysis: the bd forward against its plain version at every shape of
   ``cli.timing_analysis``'s full sweep that no phase above holds (E 8, 16,
   32; the sweep's lengths); ``utils.profiling.trace`` over one flagship eval
   chunk, its Chrome trace holding the bd forward kernel 104 times;
   ``time_fn_amortized`` of one flagship forward beside ``time_ms`` and
   ``time_fn``; ``device_memory_stats`` equal to torch.cuda's counters;
   ``cli.complexity_report`` on the card equal to the CPU's count for all
   five models, no kernel launched (a ``use_pallas`` model counted on its
   plain twin); ``native`` built here with g++ against the quant kernels
   (nearest fixed point and nearest codeword bit for bit, stochastic
   rounding by its mean) and ``data/packing.py`` (``pack_windows`` bit for
   bit); ``ar_oracle_nmse`` card vs CPU on the same windows
   (``AR_CARD_RTOL``) and ``cli.ar_oracle`` at the committed artifact's
   settings, its dB beside the artifact's (not held: another channel
   draw); ``cli.timing_analysis`` on two axes (monotonic: true);
   ``cli.eval_parity_ci`` from phase 18's checkpoint on 8 batches (104 bd
   launches), its mean within ``PARITY_CI_RTOL`` of the plain path's;
   ``cli.collect_results`` over the committed results and phase 18's; and
   ``parse_logs`` over phase 18's log, ``MetricsWriter`` writing its scalars
   (the JSONL branch where ``tensorboard`` is missing);
36. drivers: ``cli.calibrate_channel``, ``cli.calibrate_fast``,
   ``cli.prob_crossover``, ``cli.prob_profile``, ``cli.step_profile``,
   ``cli.perf_study`` and ``cli.interleaved_ab`` in this process, cut short
   (``DRIVER_ARGS``): each JSON's keys as its committed JAX artifact's, no
   row with an error, the calibration fit inside its speed grid, perf_study's
   rows each naming its route and launching the bd, mha and fixed-point
   kernels; ``cli.pallas_ab`` on copies of the committed r4ab result and
   ``parity.json``, byte for byte the committed ``pallas_ab.json``;
37. parallel: subprocesses of this script (``--parallel-rank``), each group
   killed and failed past ``PARALLEL_TIMEOUT``. Always NCCL at world 1:
   ``train_chunk_dp`` at the flagship (batch 256, f32 and bf16) against
   ``train_chunk`` from the same weights and generator (loss, state,
   last-step gradients at the kernel path's limits), 13 + 13 bd launches a
   step, samples/s of both in turns; the ring Informer (xl widths, distil
   off, eval x 64) against the full model, ms a batch; one training step of
   the ring Informer (flagship widths, seq_len 80, distil off, dropout 0)
   against the full model's (gradients at ``GRAD_TOL``; its decoder's 6 + 6
   bd launches); the flagship made tensor-parallel over a ``model`` axis of
   every rank against the replicated model: an eval batch, then one step
   (shards against their rows of the replicated gradients, the replicated
   gradients equal on every rank, 13 + 13 bd launches). Where the machine
   has 2 or more cards, the same across 2 or 4 ranks: one DP ``_update``
   against one card's on the concatenated batch, the ring with its sequence
   sharded over the ranks, and the tensor-parallel model with its weights
   sharded over them. One line says which ran. Then the two-axis part: a
   probe of gloo with CUDA tensors (2 ranks on one card: all_gather,
   all_reduce, broadcast, the ring's batched sends), and, on 4 ranks (NCCL
   with 4 cards, else gloo on the one card where the probe allows), the
   flagship and the LSQ-fibbinary flagship steps on a data 2 x model 2 mesh
   against one card's ``_update`` on the whole batch (13 + 13 bd launches a
   rank; LSQ 72 + 72 codeword on each rank's rows), a 2 x 2 step's ms beside
   one card's ``train_chunk``, and a ``Trainer`` on the mesh resumed from
   its gathered checkpoint against the uninterrupted run; then
   ``cli.multichip`` at n 1 and n 4.

The bd forward's entry in the kernels line also carries the launches of
the later paths and drivers (``int8_eval_launches``,
``streaming_launches``, ``e2e_driver_launches``, ``scale_demo_launches``,
``dp_train_launches_world1``, ``ring_train_launches_world1``,
``tp_train_launches_world1``, ``drivers16_launches``, ...), as the bd
backward's and the mha kernel's entries do theirs
(``ring_eval_launches_world1``). Each
attention kernel's entry carries its bf16 and f16 instances (time,
launches, bound at 16-bit bytes or tensor-core FLOPs, SDPA) under
``bfloat16`` and ``float16``; the mha entry its launches by route, and the
mha kernel's wgmma route has an entry of its own (``mha_attention_fwd[wgmma]``:
the bf16 xl batch's calls on that route, with each shape's time, bound,
SDPA and occupancy, and the f16 batch's under ``float16``).

With ``--profile`` each path's line also gives its device kernel launches
per chunk. The last three lines are the card's name and power limit, the kernels' JSON
record and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# f32 CUDA cores; bf16 and fp16 tensor cores (dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TENSOR_CORE_LIBS = ("bd_attention_fwd", "bd_attention_bwd", "mha_attention_fwd")
# Attention products (the bound of every attention row, forward and
# backward). The tensor cores are the card's fastest f32-accurate route: a
# TF32 pass keeps 10 mantissa bits, so an f32 product takes three passes on
# split operands (hi*hi + hi*lo + lo*hi, csrc/mma_tf32.cuh), 495 / 3
# TFLOP/s. The quant kernels' work is comparisons and stays at the f32
# CUDA-core rate.
ATTN_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}
KERNEL_DTYPES = ("float32", "bfloat16", "float16")  # the attention kernels' instances
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
# (rtol, atol), forward; float16 rounds its result at 2^-11 (bf16: 2^-8)
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2), "float16": (2e-3, 2e-3)}
# longer sums in dK, dV; tests/test_torch_f16_mma.py holds f16's datapath to it
BWD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (1e-2, 1e-2), "float16": (4e-3, 4e-3)}
# The f16 backward also at a training step's cotangents: dO times F16_TRAIN_DO,
# compared with the plain version's f32 result relative to each gradient's max
# (the results are f16 subnormals there).
F16_TRAIN_DO = 2.0 ** -17
MAIN_TOL = (1e-3, 1e-4)  # kernel path vs plain path, whole model forward, TF32 off
# bf16 kernel path vs bf16 plain path, whole model: max|kernel - plain| /
# max|plain| and NMSE(kernel, plain). The kernels compute attention in f32
# and round their output once; the plain path's einsums and softmax run in
# bf16 (as JAX's XLA path), so the two differ by bf16 rounding noise: ~1e-2
# and ~1e-4 at the flagship (tests/test_torch_bf16.py's bars against flax).
BF16_TOL = (5e-2, 1e-3)
# bf16 training step, each gradient's max abs difference over its own max
# abs (floor: BF16_GRAD_FLOOR of the largest gradient's). Every backward op
# rounds its cotangent to bf16, so the bf16 gradients of either path sit up
# to ~0.2 of their max from the f32 model's: the bar is that the kernel
# path's worst error against the f32 gradients is at most BF16_GRAD_RATIO
# times the plain path's, and that the two paths differ by at most
# BF16_GRAD_CAP.
BF16_GRAD_FLOOR, BF16_GRAD_RATIO, BF16_GRAD_CAP = 5e-2, 1.25, 0.3
# The same for float16 (cap 0.1: a probe on the card put the two paths 3.8e-2
# apart, the first encoder's query weight, and each 4.6-4.9e-2 from the f32
# twin): its cotangents round at 2^-11, but at the training batch many lie
# among f16's subnormals (below 2^-14) on either path.
F16_GRAD_FLOOR, F16_GRAD_RATIO, F16_GRAD_CAP = 1e-2, 1.25, 0.1
LOW_GRAD = {"bfloat16": (BF16_GRAD_FLOOR, BF16_GRAD_RATIO, BF16_GRAD_CAP),
            "float16": (F16_GRAD_FLOOR, F16_GRAD_RATIO, F16_GRAD_CAP)}
# float16 kernel path vs float16 plain path, whole model, as BF16_TOL:
# tests/test_torch_f16.py's bars against flax. At the xl widths the plain
# path's attention over E 128 and L 256 runs in f16, the kernels' in f32.
F16_TOL = (1e-2, 2e-5)
F16_MHA_TOL = (2e-2, 6e-5)
# Kernel path vs plain path, one training step: each gradient's max abs
# difference over the larger of its own max abs and 1e-3 of the largest
# gradient's (the two paths round the attention sums differently, and the
# difference passes through 13 layers and the backward). The floor keeps
# gradients that are zero in exact arithmetic, such as the key biases'
# (softmax ignores a constant added to a row of scores), from being compared
# noise to noise.
GRAD_TOL = 1e-3
TRAIN_STEPS = 8
# The reference's A100 training rate with ProbSparse attention (BASELINE.md:15),
# printed beside the prob training path's; not a number of this card.
A100_PROB = ("reference A100 (BASELINE.md, attn prob)", 2230)
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


def _ptxas_instances(log):
    """Each kernel of one ``nvcc -Xptxas -v`` log: its mangled name,
    registers a thread and spill bytes (stores and loads)."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out.append(dict(name=chunk.split("'", 1)[0],
                        registers=int(regs.group(1)) if regs else None,
                        spill_bytes=int(spill.group(1)) + int(spill.group(2)) if spill else 0))
    return out


def _instance_label(name):
    """``kernel<dtype, template numbers>`` of a mangled template kernel name
    and its dtype ("float32", "bfloat16", "float16", or None where the
    kernel takes no type argument)."""
    # A nested name (_ZN ... E) is a run of <length><text> parts; the
    # kernel's ends in "_kernel" and its template arguments follow (I ... E).
    i = 3 if name.startswith("_ZN") else 2
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        base, i = name[j:j + int(name[i:j])], j + int(name[i:j])
        if base.endswith("_kernel") and name.startswith("I", i) and "EEv" in name[i:]:
            break
    else:
        return name, None
    args = name[i + 1:name.index("EEv", i)]
    dtype = ("bfloat16" if args.startswith("13__nv_bfloat16")
             else "float16" if args.startswith("6__half")
             else "float32" if args.startswith("f") else None)
    nums = re.findall(r"L[ib](\d+)E", args)
    return f"{base}<{', '.join(([dtype] if dtype else []) + nums)}>", dtype


def _sass_hmma(lib):
    """Tensor-core MMA instructions (HMMA and Hopper's HGMMA) in a library's
    SASS by kernel, by cuobjdump beside nvcc (:func:`_hmma_by_function`);
    None where the toolkit has no cuobjdump."""
    from channelestimationtransformer_torch.ops.cuda import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    return _hmma_by_function(subprocess.run([str(tool), "--dump-sass", str(lib)], check=True,
                                            capture_output=True, text=True).stdout)


MMA_KINDS = ("bf16", "tf32", "f16", "other")  # tensor-core MMAs by operand type
# The MMAs each dtype's instances issue, and only these.
MMA_KIND_OF = {"bfloat16": "bf16", "float32": "tf32", "float16": "f16"}


def _mma_kind(op):
    """The operand type of an HMMA or HGMMA by the rest of its name: a BF16
    or TF32 suffix names it; f16 inputs with f32 accumulators carry none
    (``HMMA.16816.F32``, ``HGMMA.64x128x16.F32``); anything else is
    "other"."""
    if "BF16" in op:
        return "bf16"
    if "TF32" in op:
        return "tf32"
    return "f16" if re.fullmatch(r"[0-9x]+\.F32", op) else "other"


def _hmma_by_function(sass):
    """{mangled name: {"bf16": n, "tf32": n, "f16": n, "other": n, "hgmma":
    n}} of a SASS dump: each function's tensor-core MMAs (mma.sync's HMMA
    and wgmma's HGMMA) by their operand type (:func:`_mma_kind`), and how
    many of them are HGMMA."""
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = dict.fromkeys((*MMA_KINDS, "hgmma"), 0)
            continue
        op = re.search(r"\b(HG?MMA)\.(\S+)", line)
        if op and name:
            counts[name][_mma_kind(op.group(2))] += 1
            counts[name]["hgmma"] += op.group(1) == "HGMMA"
    return counts


def _build_instances(log, hmma):
    """Per kernel instance of a library: label, dtype, registers, spill
    bytes, tensor-core MMAs by operand type (``hmma_*``: HMMA and HGMMA)
    and its HGMMA (``hgmma``); the counts None without cuobjdump."""
    rows = []
    for inst in _ptxas_instances(log):
        label, dtype = _instance_label(inst["name"])
        counts = (hmma or {}).get(inst["name"], dict.fromkeys((*MMA_KINDS, "hgmma"), 0))
        rows.append(dict(label=label, dtype=dtype, registers=inst["registers"],
                         spill_bytes=inst["spill_bytes"],
                         **{f"hmma_{k}": counts[k] if hmma is not None else None
                            for k in MMA_KINDS},
                         hgmma=counts["hgmma"] if hmma is not None else None))
    return rows


def _mma_faults(instances):
    """Tensor-core instances that issue the wrong MMAs: a bfloat16, float32
    or float16 instance with no MMA of its own kind (bf16, TF32, f16; HMMA
    or HGMMA) or with any MMA of another kind, a wgmma instance (its name
    says so) with no HGMMA; and any whose dtype the name does not say."""
    def wrong(r):
        own = f"hmma_{MMA_KIND_OF[r['dtype']]}"
        return r[own] == 0 or any(r[f"hmma_{k}"] for k in MMA_KINDS if f"hmma_{k}" != own) or (
            "wgmma" in r["label"] and not r.get("hgmma"))
    return [r["label"] for r in instances if r["dtype"] not in MMA_KIND_OF or (
        r["hmma_bf16"] is not None and wrong(r))]


def _occupancy(name, *sizes):
    """What the launch of library ``name`` at ``sizes`` (its ``<name>_occupancy``
    entry's arguments) holds of an SM: blocks resident, threads, dynamic
    shared bytes, registers a thread, local (spill) bytes a thread."""
    import ctypes

    from channelestimationtransformer_torch.ops.cuda import _build

    fn = getattr(_build.load(name), f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * len(sizes) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(*sizes, out)
    if err != 0:
        fail(f"{name}_occupancy{sizes}: cudaError {err}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "registers", "local_bytes"), out))


def _occupancy_text(occ):
    return (f"{occ['registers']} registers, {occ['local_bytes']} local bytes, "
            f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads and "
            f"{occ['smem_bytes']} shared bytes an SM")


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


def bwd_bound(l_q, l_k, causal, dtype, *, b=B, h=H, e=E):
    """Least time for one backward: Q, K, V, O, dO and lse read once, dQ,
    dK, dV written once; or 10*E FLOPs per unmasked pair (QK^T and dO V^T
    once each, dQ, dK, dV) at the tensor-core rate, whichever is larger."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * b * h * e * (4 * l_q + 4 * l_k) + 4 * b * h * l_q
    return _bound(nbytes, 10 * b * h * e * _pairs(l_q, l_k, causal), dtype, ATTN_PEAK_FLOPS)


def _compare(torch, got, want, tol):
    diff = (got.float() - want.float()).abs()
    rel = (diff / want.float().abs().clamp_min(1e-3)).max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=tol[0], atol=tol[1])
    return diff.max().item(), rel, ok


def _inputs(torch, gen, dtype, l_q, l_k, *, b=B, h=H, e=E, d=None):
    return tuple(torch.randn(b, l, h, w, generator=gen, device="cuda").to(dtype)
                 for l, w in ((l_q, e), (l_k, e), (l_k, e if d is None else d)))


def _mha_route(mha, q, k, v, code):
    """The mha route of a call and what its launch holds of an SM."""
    b, l_q, h, e = q.shape
    l_k, d = k.shape[1], v.shape[3]
    route = mha.mha_route(q.dtype, l_q, l_k, e, d, mha.aligned16(q, k, v))
    return route, _occupancy(mha.LIB, b, h, l_q, l_k, e, d, code, mha.ROUTES.index(route))


def phase_kernel(torch, F, kernel_fn, reference, shapes, prefix="kernel", seed=0,
                 timed=True, mha=None):
    """An eval forward kernel against its plain version at ``shapes``
    ((label, l_q, l_k, causal, calls per eval batch, b, h, e, d)) in float32,
    bfloat16 and float16, with kernel, plain and ``F.scaled_dot_product_attention``
    times (``timed=False``: the kernel's graph time alone). With ``mha``
    (the mha wrapper's module) each row names its route, checks that the
    launch counted on that route, and reports the launch's occupancy."""
    from channelestimationtransformer_torch.ops.cuda.bd_attention import _DTYPE_CODE

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype_name in KERNEL_DTYPES:
        dtype = getattr(torch, dtype_name)
        code = _DTYPE_CODE[dtype]  # the C entries' dtype code (the mha entry's too)
        for label, l_q, l_k, causal, calls, b, h, e, d in shapes:
            q, k, v = _inputs(torch, gen, dtype, l_q, l_k, b=b, h=h, e=e, d=d)
            routed = {}
            if mha is not None:
                route, occ = _mha_route(mha, q, k, v, code)
                before = dict(mha.mha_attention_fwd.launches_by_route)
                routed = dict(route=route, occupancy=occ)
            got = kernel_fn(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if mha is not None:
                counted = {r: n - before[r]
                           for r, n in mha.mha_attention_fwd.launches_by_route.items()}
                if counted != {r: int(r == route) for r in counted}:
                    fail(f"{prefix} {label} {dtype_name}: launches by route {counted}, "
                         f"not one on the {route} route")
            want = reference(q.float(), k.float(), v.float(), causal=causal)
            rtol, atol = TOL[dtype_name]
            abs_err, rel_err, ok = _compare(torch, got, want.to(dtype), TOL[dtype_name])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def kernel():
                return kernel_fn(q, k, v, causal=causal)
            row = dict(shape=label, dtype=dtype_name, b=b, h=h, e=e, d=d, l_q=l_q, l_k=l_k,
                       causal=causal, calls_per_batch=calls, max_abs_err=abs_err,
                       max_rel_err=rel_err, rtol=rtol, atol=atol, ms=time_ms(torch, kernel),
                       **fwd_bound(l_q, l_k, causal, dtype_name, b=b, h=h, e=e, d=d), **routed)
            times = f"kernel {row['ms'] * 1e3:.1f} us"
            if timed:
                row.update(eager_ms=eager_ms(torch, kernel),
                           plain_ms=time_ms(torch, lambda: reference(q, k, v, causal=causal)),
                           library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, is_causal=causal)))
                times += (f" (eager {row['eager_ms'] * 1e3:.1f}), plain "
                          f"{row['plain_ms'] * 1e3:.1f} us, sdpa {row['library_ms'] * 1e3:.1f} us")
            rows.append(row)
            if routed:
                times += f" | {routed['route']} route: {_occupancy_text(routed['occupancy'])}"
            print(f"{prefix} {label:24s} {dtype_name:8s} max_abs {abs_err:.3e} max_rel "
                  f"{rel_err:.3e} (rtol {rtol}, atol {atol}) {'ok' if ok else 'MISMATCH'} | "
                  f"{times}, bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']})",
                  flush=True)
            if not ok:
                fail(f"{prefix} disagrees with its plain version at {label} {dtype_name}")
    return rows


def kernel_keep_mask(torch, ops, q, k, causal, seed):
    """The forward kernel's dropout mask, read back through one-hot values:
    with V's row j the unit vector of column j - E*g, output column c of
    pass g is P_drop[:, E*g + c], nonzero exactly where the key is kept
    (every unmasked probability is > 0 at these inputs). E stands for the
    head width."""
    b, l_k, h, e = k.shape
    kept = torch.zeros(b, h, q.shape[1], l_k, dtype=torch.bool, device="cuda")
    for g in range(0, l_k, e):
        cols = torch.arange(g, min(g + e, l_k), device="cuda")
        v = torch.zeros_like(k)
        v[:, cols, :, cols - g] = 1.0
        out = ops.bd_attention(q, k, v, causal=causal, dropout=DROPOUT, seed=seed)
        kept[..., g:g + e] = (out.permute(0, 2, 1, 3) != 0)[..., :len(cols)]
    return kept


def phase_kernel_train(torch, F, ops, shapes=None, prefix="train", timed=True):
    """The training kernels at ``shapes`` ((label, l_q, l_k, causal, calls
    per step, b, h, e); the flagship's by default), in each of
    ``KERNEL_DTYPES``: forward with dropout (and lse), its mask, and the
    backward, against their plain versions, with kernel, plain and SDPA
    times (``timed=False``: the kernels' graph times alone); in float16 the
    backward also at a training step's cotangents (``F16_TRAIN_DO``)."""
    if shapes is None:
        shapes = [s + (B, H, E) for s in SHAPES]
    fwd_rows, bwd_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in KERNEL_DTYPES:
        dtype = getattr(torch, dtype_name)
        for label, l_q, l_k, causal, calls, b, h, e in shapes:
            q, k, v = _inputs(torch, gen, dtype, l_q, l_k, b=b, h=h, e=e)
            do = torch.randn(b, l_q, h, e, generator=gen, device="cuda").to(dtype)
            seed = ops.draw_seed(gen, "cuda")
            scale = e ** -0.5
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
                ops.dropout_keep_mask(seed, b, h, l_q, l_k, 1.0 - DROPOUT)
                & ~torch.ones(l_q, l_k, dtype=torch.bool, device="cuda").triu(1 if causal else l_k))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def fwd():
                return ops.bd_attention_fwd(q, k, v, seed, with_lse=True, **kw)
            code = ops._DTYPE_CODE[dtype]
            row = dict(shape=label, dtype=dtype_name, b=b, h=h, e=e, l_q=l_q, l_k=l_k,
                       causal=causal, calls_per_step=calls, dropout=DROPOUT,
                       max_abs_err=abs_err, max_rel_err=rel_err, lse_max_abs_err=lse_err,
                       mask_equal=mask_ok, ms=time_ms(torch, fwd),
                       occupancy=_occupancy(ops.FWD_LIB, b, h, l_q, l_k, e, code),
                       **fwd_bound(l_q, l_k, causal, dtype_name, b=b, h=h, e=e,
                                   with_lse=True))
            times = f"kernel {row['ms'] * 1e3:.1f} us"
            if timed:
                row.update(eager_ms=eager_ms(torch, fwd),
                           plain_ms=time_ms(torch, lambda: ops._reference_forward(
                               q, k, v, seed=seed, with_lse=True, **kw)),
                           library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, dropout_p=DROPOUT, is_causal=causal)))
                times += (f" (eager {row['eager_ms'] * 1e3:.1f}), plain "
                          f"{row['plain_ms'] * 1e3:.1f} us, sdpa {row['library_ms'] * 1e3:.1f} us")
            fwd_rows.append(row)
            print(f"{prefix} fwd {label:22s} {dtype_name:8s} dropout {DROPOUT}: max_abs "
                  f"{abs_err:.3e} lse {lse_err:.3e} {'ok' if ok and lse_ok else 'MISMATCH'}, "
                  f"mask {'equal' if mask_ok else 'DIFFERS'} | {times}, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}) | "
                  f"{_occupancy_text(row['occupancy'])}", flush=True)
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
            ok = all(err[2] for err in errs + pair_errs)
            small, small_errs = "", []
            if dtype_name == "float16":
                # A training step's cotangents: relative to each gradient's max.
                do_small = (do.float() * F16_TRAIN_DO).to(dtype)
                got_small = ops.bd_attention_bwd(q, k, v, o, do_small, lse, seed, **kw)
                torch.cuda.synchronize()
                want_small = ops.bd_attention_bwd_reference(
                    q.float(), k.float(), v.float(), o.float(), do_small.float(), lse, seed, **kw)
                small_errs = [_compare(torch, g.float() / w.abs().max(), w / w.abs().max(),
                                       BWD_TOL[dtype_name])
                              for g, w in zip(got_small, want_small)]
                ok = ok and all(err[2] for err in small_errs)
                small = (f"; dO x 2^{int(math.log2(F16_TRAIN_DO))}, over each gradient's max: "
                         + " ".join(f"{err[0]:.2e}" for err in small_errs))

            def bwd():
                return ops.bd_attention_bwd(q, k, v, o, do, lse, seed, **kw)
            row = dict(shape=label, dtype=dtype_name, b=b, h=h, e=e, l_q=l_q, l_k=l_k,
                       causal=causal, calls_per_step=calls, dropout=DROPOUT,
                       max_abs_err=max(err[0] for err in errs), max_rel_err=max(err[1] for err in errs),
                       pair_max_abs_err=max(err[0] for err in pair_errs),
                       train_do_max_err=max((err[0] for err in small_errs), default=None),
                       rtol=BWD_TOL[dtype_name][0], atol=BWD_TOL[dtype_name][1],
                       ms=time_ms(torch, bwd),
                       occupancy=_occupancy(ops.BWD_LIB, b, h, l_q, l_k, e, 1, code),
                       **bwd_bound(l_q, l_k, causal, dtype_name, b=b, h=h, e=e))
            times = f"kernel {row['ms'] * 1e3:.1f} us"
            if timed:
                qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
                dog = do.transpose(1, 2)

                def sdpa_fwd():
                    return F.scaled_dot_product_attention(qg, kg, vg, dropout_p=DROPOUT,
                                                          is_causal=causal)

                def sdpa_fwd_bwd():
                    return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dog)
                row.update(eager_ms=eager_ms(torch, bwd),
                           plain_ms=time_ms(torch, lambda: ops.bd_attention_bwd_reference(
                               q, k, v, o, do, lse, seed, **kw)),
                           library_ms=time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd))
                times += (f" (eager {row['eager_ms'] * 1e3:.1f}), plain "
                          f"{row['plain_ms'] * 1e3:.1f} us, sdpa bwd "
                          f"{row['library_ms'] * 1e3:.1f} us")
            bwd_rows.append(row)
            print(f"{prefix} bwd {label:22s} {dtype_name:8s} dQ/dK/dV max_abs "
                  f"{' '.join(f'{err[0]:.2e}' for err in errs)}, vs the plain pair "
                  f"{' '.join(f'{err[0]:.2e}' for err in pair_errs)}{small} (rtol {row['rtol']}, "
                  f"atol {row['atol']}) {'ok' if ok else 'MISMATCH'} | {times}, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}) | "
                  f"{_occupancy_text(row['occupancy'])}", flush=True)
            if not ok:
                fail(f"backward kernel disagrees with its plain version at {label} {dtype_name}")
    return fwd_rows, bwd_rows


# The flagship's seven circular k=3 convolutions of a training step at batch
# CONV_B: (label, L, C_in, C_out, bias, data gradient, calls a step).
CONV_SHAPES = [
    ("embed enc L=90", 90, 16, 128, False, False, 1),
    ("embed dec L=15", 15, 16, 128, False, False, 1),
    ("distil L=90", 90, 128, 128, True, True, 1),
    ("distil L=45", 45, 128, 128, True, True, 2),
    ("distil L=23", 23, 128, 128, True, True, 2),
]
CONV_B = 1024
# Kernel against plain version, both float32 (TF32 off): forward and dx sum
# 3 * C terms in other orders (rtol/atol 1e-4 / 1e-5, as the attention
# forward); dW and db sum B * L = 92,160 rows, in splits and then their sum
# against cuBLAS's blocked order, so their atol is 1e-5 of the result's own
# largest magnitude (an error of ~sqrt(n) 2^-24 of the terms' scale).
CONV_TOL = (1e-4, 1e-5)
CONV_GRAD_RTOL, CONV_GRAD_SCALED_ATOL = 1e-4, 1e-5


def phase_circular_conv(torch, F):
    """The circular convolution's kernels (forward, data gradient, weight
    and bias gradient with its reduction) against their plain versions at
    the flagship's seven convolutions of a batch-1024 training step, float32
    with TF32 off: max errors, two runs bit for bit, device times (graph
    replay) beside the bound (FLOPs at 67 TFLOP/s FFMA or bytes at 3.35
    TB/s), the plain versions and cuDNN (``F.conv1d`` on the circularly
    padded input, its ``convolution_backward`` for the gradients). Returns
    the rows."""
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc

    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = []
    for label, l, c_in, c_out, with_bias, with_dx, calls in CONV_SHAPES:
        x = torch.randn(CONV_B, l, c_in, generator=gen, device="cuda")
        w = torch.randn(c_out, c_in, 3, generator=gen, device="cuda") / math.sqrt(3 * c_in)
        bias = torch.randn(c_out, generator=gen, device="cuda") if with_bias else None
        dy = torch.randn(CONV_B, l, c_out, generator=gen, device="cuda")
        fwd = cc.circular_conv1d_fwd(x, w, bias)
        fwd_err = _compare(torch, fwd, cc.circular_conv1d_reference(x, w, bias), CONV_TOL)
        dw, db = cc.circular_conv1d_wgrad(x, dy, with_bias)
        dw2, db2 = cc.circular_conv1d_wgrad(x, dy, with_bias)
        want_dw, want_db = cc.circular_conv1d_wgrad_reference(x, dy, with_bias)
        errs = dict(forward=fwd_err)
        for name, got, want in (("dW", dw, want_dw), ("db", db, want_db)):
            if want is not None:
                errs[name] = _compare(torch, got, want, (CONV_GRAD_RTOL, CONV_GRAD_SCALED_ATOL
                                                         * want.abs().max().item()))
        same = torch.equal(dw, dw2) and (db is None or torch.equal(db, db2))
        if with_dx:
            dx = cc.circular_conv1d_dgrad(dy, w)
            errs["dx"] = _compare(torch, dx, cc.circular_conv1d_dgrad_reference(dy, w), CONV_TOL)
            same = same and torch.equal(dx, cc.circular_conv1d_dgrad(dy, w))
        torch.cuda.synchronize()
        bad = [k for k, (_, _, ok) in errs.items() if not ok]
        # cuDNN on the padded, transposed input, TF32 off (the port's earlier route).
        xp = F.pad(x.transpose(1, 2), (1, 1), mode="circular").contiguous()
        dyt = dy.transpose(1, 2).contiguous()
        bias_sizes = [c_out] if with_bias else None

        def lib_bwd():
            return torch.ops.aten.convolution_backward(
                dyt, xp, w, bias_sizes, [1], [0], [1], False, [0], 1,
                [with_dx, True, with_bias])

        # Each pass: 2 * B * L * C_in * C_out * 3 FLOPs; one activation read, one written, W.
        bound = _bound(4 * (CONV_B * l * (c_in + c_out) + w.numel()),
                       2 * CONV_B * l * c_in * c_out * 3, "float32")
        row = dict(
            label=label, l=l, c_in=c_in, c_out=c_out, calls_per_step=calls,
            max_abs_err={k: v[0] for k, v in errs.items()}, bit_for_bit=same,
            fwd=dict(ms=time_ms(torch, lambda: cc.circular_conv1d_fwd(x, w, bias)),
                     plain_ms=time_ms(torch, lambda: cc.circular_conv1d_reference(x, w, bias)),
                     library_ms=time_ms(torch, lambda: F.conv1d(xp, w, bias)),
                     library_pad_ms=time_ms(torch, lambda: F.conv1d(
                         F.pad(x.transpose(1, 2), (1, 1), mode="circular"), w,
                         bias).transpose(1, 2).contiguous()),
                     **bound,
                     occupancy=_occupancy(cc.LIB, 0, c_in)),
            wgrad=dict(ms=time_ms(torch, lambda: cc.circular_conv1d_wgrad(x, dy, with_bias)),
                       plain_ms=time_ms(torch, lambda: cc.circular_conv1d_wgrad_reference(
                           x, dy, with_bias)),
                       **bound,
                       splits=cc._splits(x.device.index, CONV_B, l, c_in, c_out,
                                         cc._smem(1, c_in)),
                       occupancy=_occupancy(cc.LIB, 2, c_in)),
            library_bwd_ms=time_ms(torch, lib_bwd))
        if with_dx:
            row["dgrad"] = dict(
                ms=time_ms(torch, lambda: cc.circular_conv1d_dgrad(dy, w)),
                plain_ms=time_ms(torch, lambda: cc.circular_conv1d_dgrad_reference(dy, w)),
                **bound,
                occupancy=_occupancy(cc.LIB, 1, c_in))
        rows.append(row)
        print(f"conv {label} (B {CONV_B}, C_in {c_in}, C_out {c_out}, bias {with_bias}): "
              + ", ".join(f"{k} max_abs {v[0]:.3g} rel {v[1]:.3g}" for k, v in errs.items())
              + f"; two runs bit for bit {same} | forward {row['fwd']['ms'] * 1e3:.1f} us "
              f"(plain {row['fwd']['plain_ms'] * 1e3:.1f}, cuDNN "
              f"{row['fwd']['library_ms'] * 1e3:.1f}, with pad and transposes {row['fwd']['library_pad_ms'] * 1e3:.1f}), "
              + (f"dgrad {row['dgrad']['ms'] * 1e3:.1f} us (plain "
                 f"{row['dgrad']['plain_ms'] * 1e3:.1f}), " if with_dx else "")
              + f"wgrad {row['wgrad']['ms'] * 1e3:.1f} us in {row['wgrad']['splits']} splits "
              f"(plain {row['wgrad']['plain_ms'] * 1e3:.1f}), cuDNN backward "
              f"{row['library_bwd_ms'] * 1e3:.1f} us; bound forward "
              f"{row['fwd']['bound_ms'] * 1e3:.1f} us ({row['fwd']['bound_by']}) a pass | "
              f"forward {_occupancy_text(row['fwd']['occupancy'])}; wgrad "
              f"{_occupancy_text(row['wgrad']['occupancy'])}", flush=True)
        if bad or not same:
            fail(f"conv {label}: {bad or 'runs differ'}")
    per_step = {}
    for key in ("fwd", "dgrad", "wgrad"):
        have = [r for r in rows if key in r]
        per_step[key] = {k: sum(r[key][k] * r["calls_per_step"] for r in have)
                         for k in ("ms", "plain_ms", "bound_ms")}
    per_step["fwd"]["library_ms"] = sum(r["fwd"]["library_ms"] * r["calls_per_step"]
                                        for r in rows)
    per_step["fwd"]["library_pad_ms"] = sum(r["fwd"]["library_pad_ms"] * r["calls_per_step"]
                                            for r in rows)
    per_step["library_bwd_ms"] = sum(r["library_bwd_ms"] * r["calls_per_step"] for r in rows)
    print("conv, one training step (7 forwards, 5 dgrads, 7 wgrads): "
          + "; ".join(f"{k} {v['ms'] * 1e3:.1f} us (plain {v['plain_ms'] * 1e3:.1f}, bound "
                      f"{v['bound_ms'] * 1e3:.1f})" for k, v in per_step.items()
                      if isinstance(v, dict))
          + f"; cuDNN forward {per_step['fwd']['library_ms'] * 1e3:.1f} us (with pad and "
          f"transposes {per_step['fwd']['library_pad_ms'] * 1e3:.1f}), cuDNN backward "
          f"{per_step['library_bwd_ms'] * 1e3:.1f} us", flush=True)
    return dict(rows=rows, per_step=per_step)


def _card_data(torch, seq_len, pred_len, samples=65536, slots=None):
    """A random window dataset resident on the card (seed 0), by default
    65,536 x 100 x 16 samples (as ``bench.py``)."""
    from channelestimationtransformer_torch.core.config import DataConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset

    data = DataConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(samples, slots or data.slots, data.features, generator=gen, device="cuda")
    return WindowDataset(h=h, seq_len=seq_len, pred_len=pred_len, snr_db=data.snr_db,
                         device="cuda")


def _models_and_data(torch, cfg=None, samples=65536, slots=None):
    """The kernel-path model (seed 0), the plain-path model with the same
    weights, and :func:`_card_data` for ``cfg`` (by default the flagship
    config)."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import build_informer

    cfg = cfg or InformerConfig(use_pallas=True)
    model = build_informer(cfg, device="cuda", seed=0)
    plain = build_informer(dataclasses.replace(cfg, use_pallas=False), device="cuda", seed=0)
    plain.load_state_dict(model.state_dict())
    return cfg, model, plain, _card_data(torch, cfg.seq_len, cfg.pred_len, samples, slots)


def _f32_twin(model, cfg):
    """The float32 model of ``cfg`` (kernel path) with ``model``'s weights."""
    from channelestimationtransformer_torch.models.informer import build_informer

    twin = build_informer(dataclasses.replace(cfg, dtype="float32"), device="cuda", seed=0)
    twin.load_state_dict(model.state_dict())
    return twin


def _rel_nmse(got, want):
    """max|got - want| / max|want| and NMSE(got, want), in f32."""
    got, want = got.float(), want.float()
    diff = got - want
    return ((diff.abs().max() / want.abs().max()).item(),
            (diff.square().sum() / want.square().sum()).item())


LOW_TOL = {"bfloat16": BF16_TOL, "float16": F16_TOL}  # whole model, by activation dtype


def _close(torch, got, want, dtype, tol=None):
    """Kernel path against plain path, one model output: (text, ok) at
    MAIN_TOL in f32, at ``tol`` (max|Δ|/max, NMSE; by default
    ``LOW_TOL[dtype]``) in bf16 and f16."""
    if dtype == "float32":
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
        return f"max_abs {err:.3e} (rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]})", ok, err
    tol = tol or LOW_TOL[dtype]
    rel, nm = _rel_nmse(got, want)
    ok = bool(torch.isfinite(got).all()) and rel <= tol[0] and nm <= tol[1]
    return (f"max_abs/max {rel:.3e}, nmse {nm:.3e} (limits {tol[0]}, {tol[1]})",
            ok, (got.float() - want.float()).abs().max().item())


def _reduced_flag(dtype):
    """cuBLAS's reduced-precision-reduction switch of a 16-bit activation
    dtype (``torch.backends.cuda.matmul``'s attribute name)."""
    return {"bfloat16": "allow_bf16_reduced_precision_reduction",
            "float16": "allow_fp16_reduced_precision_reduction"}[dtype]


# Printed names of the kernel wrappers' launch counters (keys of _counts).
COUNT_LABELS = dict(bd_fwd="bd", bd_bwd="bd backward", mha="mha", fixed="fixed",
                    codeword="codeword", conv="conv", conv_dgrad="conv dgrad",
                    conv_wgrad="conv wgrad", conv_reduce="conv reduce")


def _zero_counts(wrappers):
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
        if hasattr(fn, "reductions"):
            fn.reductions = 0


def _counts(wrappers):
    """Each wrapper's launches by key; the conv weight gradient's reductions
    as ``conv_reduce``."""
    counts = {key: fn.launches for key, fn in wrappers.items()}
    if "conv_wgrad" in wrappers:
        counts["conv_reduce"] = wrappers["conv_wgrad"].reductions
    return counts


# A float32 InformerStack of e_layers (4, 3) on the card runs 7 circular k=3
# convs a forward on the conv kernels (ops/cuda/circular_conv.py): 2
# embeddings and 5 distil convs. Its training step adds the data gradient of
# the 5 distil convs (the embeddings' input is data) and the weight gradient,
# a pass and its reduction, of all 7. bf16 and f16 convs take cuDNN.
FLAGSHIP_CONVS, FLAGSHIP_DISTIL = 7, 5


def _conv_launches(forwards=0, steps=0, convs=FLAGSHIP_CONVS, distil=FLAGSHIP_DISTIL):
    """The conv kernels' launches (keys of :func:`_counts`) of ``forwards``
    eval forwards and ``steps`` training steps of a float32 model with
    ``convs`` circular k=3 convs, ``distil`` of them on a hidden input."""
    return dict(conv=convs * (forwards + steps), conv_dgrad=distil * steps,
                conv_wgrad=convs * steps, conv_reduce=convs * steps)


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
        # the device-side shadows of the program's spans (``cet.``) are not device work
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("cet.")]
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
                    samples=65536, slots=None, batch=256, expected=None, beside=None,
                    expected_routes=None, tol=None):
    """``eval_chunk`` of 8 batches through the kernels: the launch counts
    ``expected`` (by key of :func:`_counts`; by default every attention call
    on the bd forward kernel; a float32 ``cfg`` adds its 7 convs a forward,
    :func:`_conv_launches`) and none elsewhere, the mha launches by route
    ``expected_routes`` where given, a finite NMSE, one batch
    against the plain path (each model given a generator of the same seed,
    so a ProbSparse model draws the same ``index_sample``), and samples/s of
    both paths and of the ``beside`` models (name -> model, or a function
    of the kernel-path model giving them), all in turns. A bf16 or f16
    ``cfg`` (held at ``tol``, by default ``LOW_TOL``) also times its f32
    twin (same weights) in the turns, and prints the NMSE of its prediction
    against the twin's on the batch, with cuBLAS's reduced-precision
    reductions of its dtype off (this script's setting) and on."""
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import eval_chunk
    from channelestimationtransformer_torch.utils.complexity import model_complexity

    cfg, model, plain, ds = _models_and_data(torch, cfg, samples, slots)
    if callable(beside):
        beside = beside(model)
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
    routes = dict(wrappers["mha"].launches_by_route)
    want = (expected or {"bd_fwd": 13 * n_batches}) | (
        _conv_launches(forwards=n_batches) if cfg.dtype == "float32" else {})
    expected = {key: want.get(key, 0) for key in launches}
    nmse, split = res["nmse"].item(), res["split"].cpu().tolist()
    print(f"{name}: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, split "
          f"{[round(s, 6) for s in split]}, launches {_launch_report(launches, expected)}"
          + (f"; mha by route {routes} (expected {expected_routes})" if expected_routes
             else ""), flush=True)
    if launches != expected:
        fail(f"kernels launched {launches} times on the {name}, not {expected}")
    if expected_routes is not None and routes != expected_routes:
        fail(f"mha launched {routes} times by route on the {name}, not {expected_routes}")
    if not (math.isfinite(nmse) and len(split) == cfg.pred_len
            and all(math.isfinite(s) for s in split)):
        fail(f"non-finite NMSE on the {name}")

    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(2))

    def draws():
        return torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        p_kernel, p_plain = (m(x_enc, x_dec, generator=draws()) for m in (model, plain))
    text, ok, err = _close(torch, p_kernel, p_plain, cfg.dtype, tol)
    ok = ok and p_kernel.shape == target.shape and p_kernel.dtype == p_plain.dtype
    print(f"{name} vs plain attention path, one batch ({p_kernel.dtype}): {text} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"kernel path and plain path disagree on the {name}")
    vs_f32 = {}
    if cfg.dtype != "float32":
        twin = _f32_twin(model, cfg)
        beside = {"f32-kernel": twin, **(beside or {})}
        matmul = torch.backends.cuda.matmul
        with torch.no_grad():
            p_f32 = twin(x_enc, x_dec)
            for reduced in (False, True):
                setattr(matmul, _reduced_flag(cfg.dtype), reduced)
                vs_f32[reduced] = _rel_nmse(model(x_enc, x_dec), p_f32)[1]
            setattr(matmul, _reduced_flag(cfg.dtype), False)
        print(f"{name} vs its f32 twin (same weights and batch): nmse {vs_f32[False]:.3e} "
              f"(with {cfg.dtype} reduced-precision reductions: {vs_f32[True]:.3e})",
              flush=True)
        if not all(math.isfinite(v) for v in vs_f32.values()):
            fail(f"non-finite NMSE against the f32 twin on the {name}")
    # The counter sees aten ops and not the conv kernels, which the plain path
    # takes on the card: one window on a CPU copy, times the batch.
    batch_flops = 2 * batch * model_complexity(plain, x_enc[:1], x_dec[:1])["macs_total"]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}: {n_params:,} parameters, {batch_flops / 1e9:.1f} GFLOP per batch of "
          f"{batch} (FlopCounterMode, plain path, on the CPU)", flush=True)

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
    return dict(nmse=nmse, split=split, launches=launches, launches_by_route=routes,
                vs_plain_max_abs=err, parameters=n_params, batch_flops=batch_flops,
                dtype=cfg.dtype,
                vs_f32_nmse=vs_f32.get(False), vs_f32_nmse_reduced=vs_f32.get(True), **summary)


def _grad_errors(got, want, floor):
    """Each gradient's max abs difference over its own max abs, or ``floor``."""
    return {n: (got[n] - want[n]).abs().max().item() / max(want[n].abs().max().item(), floor)
            for n in want}


@contextlib.contextmanager
def _maxpool_routing(torch, indices, replay=False):
    """The distil layers' max pooling (``models/encoder.py:ConvLayer``, the
    only caller of ``max_pool1d``) inside this block: it appends each call's
    argmax to ``indices``, or with ``replay`` takes its values at the
    recorded argmax in order, so that the gradient flows through the same
    window entries, and appends the count of windows whose own argmax
    differs. Two forwards that differ by ~1e-6 route a gradient differently
    wherever two entries of a window are that close, and one such window
    moves a distil weight's gradient by percents (seen in an LSQ-fibbinary
    step, and on the CPU between the two plain routes), which says nothing
    of the kernels."""
    import torch.nn.functional as F

    real = F.max_pool1d
    recorded = iter(list(indices)) if replay else None
    flips = []

    def pool(x, kernel_size, stride, padding):
        y, own = real(x, kernel_size, stride, padding, return_indices=True)
        if not replay:
            indices.append(own)
            return y
        idx = next(recorded)
        flips.append(int((own != idx).sum()))
        return x.gather(2, idx)
    F.max_pool1d = pool
    try:
        yield flips
    finally:
        F.max_pool1d = real


def phase_train_path(torch, wrappers, card, profile, cfg=None, name="train", per_step=None,
                     beside=None, reference=None):
    """The training path (``cfg``, by default the f32 flagship): one step
    through the kernels against one through the plain attention path (same
    weights, batch and generator seed, so the same dropout masks and
    ProbSparse draws; the plain path's max pooling, and a bf16 or f16
    ``cfg``'s f32 twin's, take the kernel path's routing, :func:`_maxpool_routing`),
    the launch counts of
    ``train_chunk`` (``per_step``
    a step by key of :func:`_counts`; by default the 13 attention calls on
    the bd forward and backward kernels; a float32 ``cfg`` adds its convs'
    kernels, :func:`_conv_launches`) and its loss, and steady-state
    samples/s of both paths and of the ``beside`` models (a function of the
    kernel-path model giving name -> model) in turns; ``reference`` (label,
    samples/s) is printed beside them. A bf16 or f16 ``cfg`` holds its
    gradients to its f32 twin's (same weights) too (``LOW_GRAD``), times the
    twin in the turns, and checks that the parameters and Adam state stay
    f32."""
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.train.trainer import create_train_state, train_chunk

    cfg, model, plain, ds = _models_and_data(torch, cfg)
    low = cfg.dtype != "float32"  # bf16 or f16 activations
    batch = 256

    # (a) One step's loss and gradients, kernel path vs plain path: the same
    # weights, batch and generator seed, hence the same dropout masks.
    x_enc, x_dec, target = make_batch(ds, batch, cfg.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(3))
    paths = {"kernel": model, "plain": plain}
    if low:
        paths["f32"] = _f32_twin(model, cfg)
    results = {}
    # The paths after the first take its max-pooling routing (in bf16 and f16
    # the f32 twin too).
    routing, flips = [], {}
    for i, (path, m) in enumerate(paths.items()):
        m.train()
        with _maxpool_routing(torch, routing, replay=i > 0) as path_flips:
            pred = m(x_enc, x_dec, generator=torch.Generator(device="cuda").manual_seed(4))
        flips[path] = sum(path_flips)
        loss = nmse(pred, target)
        loss.backward()
        results[path] = (pred.detach(), loss.item(),
                         {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                         {n: b.clone() for n, b in m.named_buffers() if "running" in n})
        m.zero_grad(set_to_none=True)
    (pk, lk, gk, sk), (pp, lp, gp, sp) = results["kernel"], results["plain"]
    stat_err = max(((sk[n] - sp[n]).abs().max()).item() for n in sp)
    if low:
        _, _, gf, _ = results["f32"]
        grad_floor, grad_ratio, grad_cap = LOW_GRAD[cfg.dtype]
        floor = grad_floor * max(g.abs().max().item() for g in gf.values())
        grad_err = _grad_errors(gk, gp, floor)
        vs_f32 = {path: max(_grad_errors(results[path][2], gf, floor).values())
                  for path in ("kernel", "plain")}
        out_text, out_ok, out_err = _close(torch, pk, pp, cfg.dtype)
        worst = max(grad_err, key=grad_err.get)
        ok = (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and out_ok
              and grad_err[worst] <= grad_cap
              and vs_f32["kernel"] <= grad_ratio * vs_f32["plain"]
              and stat_err <= 1e-2 and pk.dtype == getattr(torch, cfg.dtype))
        grad_text = (f"worst max_abs/max {grad_err[worst]:.3e} at {worst} (cap {grad_cap}, "
                     f"floor {grad_floor} of the largest f32 gradient); against the f32 "
                     f"twin's gradients: kernel path worst {vs_f32['kernel']:.3e}, plain path "
                     f"{vs_f32['plain']:.3e} (limit {grad_ratio}x); max pooling routed "
                     f"as the kernel path's, whose argmax differs from the plain path's and "
                     f"the twin's own in {flips['plain']} and {flips['f32']} windows")
    else:
        floor = 1e-3 * max(g.abs().max().item() for g in gp.values())
        grad_err = _grad_errors(gk, gp, floor)
        vs_f32 = {}
        out_err = (pk - pp).abs().max().item()
        out_text = f"max_abs {out_err:.3e} (rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]})"
        worst = max(grad_err, key=grad_err.get)
        ok = (math.isfinite(lk) and abs(lk - lp) <= MAIN_TOL[0] * abs(lp)
              and torch.allclose(pk, pp, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
              and grad_err[worst] <= GRAD_TOL and stat_err <= MAIN_TOL[1])
        grad_text = (f"worst max_abs/max {grad_err[worst]:.3e} at {worst} (limit {GRAD_TOL}; "
                     f"max pooling routed as the kernel path's, whose argmax differs from "
                     f"the plain path's own in {flips['plain']} windows)")
    print(f"{name} step, kernel path vs plain path (same weights, batch, masks; {pk.dtype}): "
          f"loss {lk:.6f} vs {lp:.6f}, output {out_text}, {len(grad_err)} gradients, "
          f"{grad_text}, BatchNorm stats max_abs {stat_err:.3e} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"kernel path and plain path disagree on one {name} step")

    # (b, c) train_chunk through the kernels: launch counts and a finite loss.
    train_cfg = TrainConfig(batch_size=batch, lr=1e-4)
    states = {"kernel": create_train_state(model, train_cfg),
              "plain": create_train_state(plain, train_cfg)}
    if low:
        states["f32-kernel"] = create_train_state(paths["f32"], train_cfg)
    for path, m in (beside(model) if beside else {}).items():
        states[path] = create_train_state(m, train_cfg)

    def run(path, seed, steps=TRAIN_STEPS):
        return train_chunk(states[path], ds, num_steps=steps, batch_size=batch,
                           label_len=cfg.label_len,
                           generator=torch.Generator(device="cuda").manual_seed(seed))

    torch.cuda.synchronize()
    _zero_counts(wrappers)
    m = run("kernel", 5)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    fwd, bwd = launches["bd_fwd"], launches["bd_bwd"]
    per = (per_step or dict(bd_fwd=13, bd_bwd=13)) | (
        _conv_launches(steps=1) if cfg.dtype == "float32" else {})
    expected = {key: TRAIN_STEPS * per.get(key, 0) for key in launches}
    loss = m["loss_sum"].item() / TRAIN_STEPS
    split = (m["split_sum"] / TRAIN_STEPS).cpu().tolist()
    print(f"{name} path: train_chunk {TRAIN_STEPS} x {batch}: mean loss {loss:.6f}, split "
          f"{[round(s, 6) for s in split]}, launches {_launch_report(launches, expected)}",
          flush=True)
    if launches != expected:
        fail(f"kernels launched {launches} times on the {name} path, not {expected}")
    if not (math.isfinite(loss) and all(math.isfinite(s) for s in split)):
        fail(f"non-finite loss on the {name} path")
    if low:
        opt = states["kernel"].optimizer
        state_dtypes = {t.dtype for st in opt.state.values() for t in st.values()
                        if torch.is_tensor(t)}
        param_dtypes = {p.dtype for p in model.parameters()}
        print(f"{name} path: parameter dtypes {sorted(map(str, param_dtypes))}, Adam state "
              f"dtypes {sorted(map(str, state_dtypes))} (expected float32 only)", flush=True)
        if param_dtypes != {torch.float32} or state_dtypes != {torch.float32}:
            fail(f"the {name} path's parameters or Adam state left float32")

    # (d) Steady state, the paths in turns.
    torch.cuda.reset_peak_memory_stats()
    times = _alternate(torch, lambda path, i: run(path, 100 + i), rounds=10,
                       names=tuple(states))
    samples = TRAIN_STEPS * batch
    summary = {}
    for path, ts in times.items():
        ts = ts[2:]
        med = statistics.median(ts)
        summary[path] = dict(chunk_ms_median=med * 1e3, samples_per_s=samples / med,
                             chunk_ms=[t * 1e3 for t in ts])
        print(f"{name} {path:6s} path: {samples / med:.1f} samples/s (median of {len(ts)} "
              f"chunks of {TRAIN_STEPS} steps x {batch}, {med * 1e3:.3f} ms) on {card}"
              + (f"; {reference[0]}: {reference[1]:,} samples/s" if reference else ""),
              flush=True)
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if profile:  # (e)
        summary.update(_profile(torch, lambda path: run(path, 7), "train_chunk", card,
                                f"profile_{name.replace(' ', '_')}.txt"))
    return dict(loss=loss, split=split, launches_fwd=fwd, launches_bwd=bwd, launches=launches,
                dtype=cfg.dtype, step_loss=(lk, lp), step_out_max_abs=out_err,
                step_grad_rel_err=grad_err, step_grad_vs_f32=vs_f32, step_stats_max_abs=stat_err,
                step_maxpool_flips=sum(flips.values()), **summary)


def _unfused_names(name):
    """The unfused parameters a fused ``qkv`` / ``kv`` parameter stacks, in order."""
    *path, proj, leaf = name.split(".")
    parts = {"qkv": ("query", "key", "value"), "kv": ("key", "value")}.get(proj, (proj,))
    return [".".join([*path, part, leaf]) for part in parts]


def _split_fused(tensors):
    """A fused model's parameters (or gradients) by the unfused model's
    names: each ``qkv`` / ``kv`` split along its output rows."""
    out = {}
    for name, t in tensors.items():
        names = _unfused_names(name)
        out.update(zip(names, t.chunk(len(names), dim=0)) if len(names) > 1 else {name: t})
    return out


def _unfused_twin(model):
    """The unfused model (kernel path) carrying a ``fuse_qkv`` model's
    weights: its query, key and value kernels stacked are the fused ones."""
    from channelestimationtransformer_torch.models.informer import build_informer

    twin = build_informer(dataclasses.replace(model.config, fuse_qkv=False), device="cuda",
                          seed=0)
    twin.load_state_dict({k: v.clone() for k, v in _split_fused(model.state_dict()).items()})
    return twin


def phase_fused_vs_unfused(torch, card):
    """``fuse_qkv`` against the unfused model with the same weights, both on
    the kernels: one eval batch and one training step (dropout 0.05, the
    same generator seed: the same masks), loss, output and every gradient
    (the fused ones split by rows) at the path tolerances."""
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.data.windows import make_batch

    _, model, _, ds = _models_and_data(torch, InformerConfig(use_pallas=True, fuse_qkv=True),
                                       samples=4096)
    twin = _unfused_twin(model)
    x_enc, x_dec, target = make_batch(ds, 256, model.config.label_len,
                                      generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        p_fused, p_twin = model(x_enc, x_dec), twin(x_enc, x_dec)
    eval_text, eval_ok, eval_err = _close(torch, p_fused, p_twin, "float32")
    results = {}
    for path, m in (("fused", model), ("unfused", twin)):
        m.train()
        pred = m(x_enc, x_dec, generator=torch.Generator(device="cuda").manual_seed(4))
        loss = nmse(pred, target)
        loss.backward()
        results[path] = (pred.detach(), loss.item(),
                         {n: p.grad.detach().clone() for n, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    (pf, lf, gf), (pu, lu, gu) = results["fused"], results["unfused"]
    gf = _split_fused(gf)
    floor = 1e-3 * max(g.abs().max().item() for g in gu.values())
    grad_err = _grad_errors(gf, gu, floor)
    worst = max(grad_err, key=grad_err.get)
    out_err = (pf - pu).abs().max().item()
    ok = (eval_ok and set(gf) == set(gu) and math.isfinite(lf)
          and abs(lf - lu) <= MAIN_TOL[0] * abs(lu)
          and torch.allclose(pf, pu, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
          and grad_err[worst] <= GRAD_TOL)
    print(f"fused vs unfused (same weights, the kernels on both): eval batch {eval_text}; "
          f"train step loss {lf:.6f} vs {lu:.6f}, output max_abs {out_err:.3e}, {len(gu)} "
          f"gradients, worst max_abs/max {grad_err[worst]:.3e} at {worst} (limit {GRAD_TOL}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the fused model and the unfused model with its weights disagree")
    return dict(eval_max_abs=eval_err, step_loss=(lf, lu), step_out_max_abs=out_err,
                step_grad_rel_err=grad_err)

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
        expected = ({k: 0 for k in launches} | dict(fixed=1, bd_fwd=13 * n_batches)
                    | _conv_launches(forwards=n_batches))
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


def phase_one_batch(torch, wrappers, name, cfg, expected):
    """One eval batch of 256 of ``cfg`` through the kernels, against its
    plain path (the kernels' plain versions and plain attention), with the
    launch counts ``expected`` (a float32 ``cfg`` adds its convs') and none
    elsewhere."""
    from channelestimationtransformer_torch.data.windows import make_batch

    cfg, model, plain, ds = _models_and_data(torch, cfg, samples=4096)
    x_enc, x_dec, _ = make_batch(ds, 256, cfg.label_len,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    with torch.no_grad():
        p_kernel = model(x_enc, x_dec)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    want = expected | (_conv_launches(forwards=1) if cfg.dtype == "float32" else {})
    expected = {key: want.get(key, 0) for key in launches}
    with torch.no_grad():
        p_plain = plain(x_enc, x_dec)
    text, ok, err = _close(torch, p_kernel, p_plain, cfg.dtype)
    print(f"{name}: launches {_launch_report(launches, expected)}; vs plain path "
          f"({p_kernel.dtype}): {text} {'ok' if ok else 'MISMATCH'}", flush=True)
    if launches != expected:
        fail(f"kernels launched {launches} times on the {name}, not {expected}")
    if not ok:
        fail(f"kernel path and plain path disagree on the {name}")
    return dict(launches=launches, vs_plain_max_abs=err, dtype=cfg.dtype)


# The datagen phase: CDL-B (default model, 64 x 2 antennas, 100 slots) one
# chunk of 128 samples on the card against the CPU from the same draws, then
# the parity recipe's data (CDLModel.calibrated(5.0), 16,384 train + 2,048 val
# samples of 100 slots, streams (seed + 100, 0) and (seed + 100, 1) at seed 0,
# as cli/train_informer.py keys them).
DATAGEN_TOL = 1e-4  # card vs CPU, max abs on the standardised dataset
CARD_BATCH = 128
PARITY_SAMPLES = (16384, 2048)
LAGS = (1, 2, 3, 5, 10)
# The cli phase: cli.train_informer's short recipe; the bd kernels launch 13
# times a training step (forward and backward) and 13 times a validation batch
# (8 a validation).
CLI_EPOCHS, CLI_STEPS = 2, 20
CLI_ARGS = ["--snr", "20", "--calibrated", "--ue-speed-kmh", "5", "--use-pallas",
            "--epochs", str(CLI_EPOCHS), "--steps-per-epoch", str(CLI_STEPS),
            "--train-samples", "1024", "--val-samples", "512", "--log-every", "10"]


def lag_curve(torch, h):
    """Mean-removed lag-k correlation magnitude of an ri dataset ``[N, T, ...,
    2]``, each sample scaled to unit RMS, as ``experiments/calibrate_channel.py:
    lag_curve`` computes it for ``calibration.json`` (float64 sums)."""
    x = torch.view_as_complex(h.double().contiguous()).reshape(h.shape[0], h.shape[1], -1)
    x = x / x.abs().square().mean(dim=(1, 2), keepdim=True).sqrt()
    xm = x - x.mean(dim=1, keepdim=True)
    out = {}
    for k in LAGS:
        a, b = xm[:, :-k].reshape(-1), xm[:, k:].reshape(-1)
        out[k] = (torch.vdot(a, b).abs() / (a.norm() * b.norm())).item()
    return out


def phase_datagen(torch, card):
    """The channel generator on the card: one chunk against the CPU from the
    same draws (``DATAGEN_TOL``, the beams kept equal), the parity recipe's
    data with its time, rate, peak memory and statistics, and a reference
    pickle round trip, bit for bit."""
    from channelestimationtransformer_torch.channel.cdl import CDLDraws, CDLModel
    from channelestimationtransformer_torch.channel.dataset import (
        generate_beamformed_dataset,
        save_reference_format,
    )
    from channelestimationtransformer_torch.data.windows import WindowDataset, pack_features

    model = CDLModel()
    draws = CDLDraws.sample(model, CARD_BATCH, torch.Generator().manual_seed(0), device="cpu")
    (h_dev, sel_dev), (h_cpu, sel_cpu) = (
        generate_beamformed_dataset(0, model=model, num_samples=CARD_BATCH, num_slots=100,
                                    device=dev, draws=[draws], return_selected=True)
        for dev in ("cuda", "cpu"))
    err = (h_dev.cpu() - h_cpu).abs().max().item()
    differ = int((sel_dev.cpu() != sel_cpu).any(dim=1).sum())
    ok = err <= DATAGEN_TOL and not differ
    print(f"datagen cuda vs cpu (CDL-B 64x2, 100 slots, {CARD_BATCH} samples, one chunk "
          f"of draws): max_abs {err:.3e} (limit {DATAGEN_TOL}), selected "
          f"{'equal' if not differ else f'DIFFERENT in {differ} samples'}"
          f" {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the channel generator on the card disagrees with the CPU")
    result = dict(card_vs_cpu_max_abs=err)

    cdl = CDLModel.calibrated(5.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the generation's own peak: above what is held now
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (train, sel_train), (val, sel_val) = (
        generate_beamformed_dataset((100, i), model=cdl, num_samples=n, num_slots=100,
                                    device="cuda", return_selected=True)
        for i, n in enumerate(PARITY_SAMPLES))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_all = sum(PARITY_SAMPLES)
    both = torch.cat([train, val])
    mean = both.mean(dim=1)  # complex mean per (sample, rx, beam): [N, U, beams, 2]
    var = (both - both.mean(dim=1, keepdim=True)).square().sum(dim=(1, 4)) / (both.shape[1] - 1)
    sel = torch.cat([sel_train, sel_val]).sort(dim=1).values
    distinct = bool((sel.diff(dim=1) != 0).all())
    finite = bool(torch.isfinite(both).all())
    mean_err, var_err = mean.abs().max().item(), (var - 1).abs().max().item()
    lags = lag_curve(torch, both)
    ok = finite and distinct and mean_err <= 1e-5 and var_err <= 1e-4
    print(f"datagen parity data (CDLModel.calibrated(5.0), {PARITY_SAMPLES[0]:,} train + "
          f"{PARITY_SAMPLES[1]:,} val samples x 100 slots, {both.numel() * 4 / 1e6:.1f} MB packed "
          f"f32): {secs:.3f} s, {n_all / secs:,.1f} samples/s, max_memory_allocated "
          f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before | finite "
          f"{finite}, max |mean| {mean_err:.2e} (limit 1e-05), max |var(N-1) - 1| "
          f"{var_err:.2e} (limit 1e-04), four distinct beams a sample "
          f"{distinct} | lag correlation " + ", ".join(f"{k}: {v:.4f}" for k, v in lags.items())
          + f" {'ok' if ok else 'FAILED'} | {card}", flush=True)
    if not ok:
        fail("the parity recipe's data fail their checks")
    result.update(seconds=secs, samples_per_s=n_all / secs, max_memory_allocated=peak,
                  memory_allocated_before=base, max_abs_mean=mean_err, max_abs_var_err=var_err,
                  lag_curve=lags)

    path = OUT / "datagen_val.pickle"
    save_reference_format(str(path), val)
    ds = WindowDataset.from_pickle(str(path), seq_len=90, pred_len=5, snr_db=20.0, device="cuda")
    path.unlink()
    same = torch.equal(ds.h, pack_features(val))
    print(f"datagen pickle round trip: save_reference_format -> WindowDataset.from_pickle, "
          f"{tuple(ds.h.shape)} {'bit for bit' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("the reference pickle round trip changed the dataset")
    return result


def phase_cli(torch, wrappers):
    """``cli.train_informer.main`` in this process on a short recipe: the bd
    launch counts against 13 x (steps + 8 x epochs) forward and 13 x steps
    backward, the conv kernels' as :func:`_conv_launches`, none elsewhere;
    finite losses; the result JSON written."""
    from channelestimationtransformer_torch.cli import train_informer

    out = OUT / "cli"
    argv = [*CLI_ARGS, "--out", str(out)]
    steps = CLI_EPOCHS * CLI_STEPS
    expected = {key: 0 for key in _counts(wrappers)}
    expected.update(bd_fwd=13 * (steps + 8 * CLI_EPOCHS), bd_bwd=13 * steps,
                    **_conv_launches(forwards=8 * CLI_EPOCHS, steps=steps))
    log = io.StringIO()
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = train_informer.main(argv)
    secs = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    launches = _counts(wrappers)
    losses = [float(v) for v in re.findall(r"\| loss (\S+)", log.getvalue())]
    valid = [float(v) for v in re.findall(r"valid loss (\S+)", log.getvalue())]
    written = (out / f"result_{result['name']}.json").exists()
    finite = (bool(losses) and len(valid) == CLI_EPOCHS
              and all(math.isfinite(v) for v in losses + valid + [result["final_val_nmse"]]))
    print(f"cli phase: cli.train_informer {' '.join(argv)}: {secs:.1f} s; launches "
          f"{_launch_report(launches, expected)}; train loss {losses[-1] if losses else None}, "
          f"valid loss {valid[-1] if valid else None}, final_val_nmse "
          f"{result['final_val_nmse']:.5f}; finite {finite}, result JSON written {written}",
          flush=True)
    if launches != expected:
        fail(f"kernels launched {launches} times in the cli phase, not {expected}")
    if not (finite and written):
        fail("the cli phase's losses are not finite or its result JSON is missing")
    return dict(argv=argv, seconds=secs, launches=launches, losses=losses, valid_losses=valid,
                result=result, log=log.getvalue())


# The LSQ training phase: cli.train_lsq's short recipe from the cli phase's
# checkpoint (the driver draws its 2,048 validation samples, as JAX's). Per
# training step 72 LSQ-mode codeword launches (the forward), 72 snap-mode
# launches (the backward's rebuilt chain) and 13 bd forward and backward; per
# validation batch 72 LSQ-mode and 13 bd forward launches (8 a validation).
LSQ_TRAIN_EPOCHS, LSQ_TRAIN_STEPS = 2, 20
LSQ_TRAIN_ARGS = ["--fibbinary", "--nbits-min", str(LSQ_NBITS), "--nbits-max", str(LSQ_NBITS),
                  "--snr", "20", "--calibrated", "--ue-speed-kmh", "5", "--use-pallas",
                  "--epochs", str(LSQ_TRAIN_EPOCHS), "--steps-per-epoch", str(LSQ_TRAIN_STEPS),
                  "--train-samples", "1024"]


def phase_lsq_train(torch, wrappers, lsq, checkpoint):
    """``cli.train_lsq.main`` in this process from ``checkpoint``: the
    preload (every checkpoint weight in place, each ``step_size`` kept from
    the LSQ model's initial weights and not the loaded ones), the launch
    counts (LSQ mode counted apart by a spy on its wrapper), finite losses
    and the results JSON written."""
    from channelestimationtransformer_torch.cli import train_lsq
    from channelestimationtransformer_torch.ops.quant.lsq import DenseLSQ

    out = OUT / "lsq_train"
    argv = [*LSQ_TRAIN_ARGS, "--checkpoint", str(checkpoint), "--out", str(out)]
    preload = {}
    real_preload, real_lsq_mode = train_lsq.load_weights_overlay, lsq.fused_lsq_codeword
    lsq_mode = []

    def checked_preload(path, model):
        layers = {n: m for n, m in model.named_modules() if isinstance(m, DenseLSQ)}
        before = {n: (m.weight.detach().clone(), m.step_size.detach().clone())
                  for n, m in layers.items()}
        names = real_preload(path, model)
        saved = torch.load(path, map_location="cuda", weights_only=True)["model"]
        now = model.state_dict()
        init = lsq.lsq_step_size_init
        preload.update(
            replaced=len(names), layers=len(layers),
            weights_equal=set(names) == set(saved) and all(torch.equal(now[k], saved[k])
                                                           for k in names),
            # Bit for bit the init weights' mean|w| / sqrt(Qp), and not the loaded
            # ones', each taken on the CPU, where build_informer initialises.
            step_sizes_kept=all(torch.equal(m.step_size.detach(), before[n][1])
                                and torch.equal(before[n][1].cpu(),
                                                init(before[n][0].cpu(), LSQ_NBITS))
                                for n, m in layers.items()),
            step_sizes_not_from_loaded=not any(
                torch.equal(m.step_size.detach().cpu(), init(m.weight.detach().cpu(), LSQ_NBITS))
                for m in layers.values()))
        return names

    def counted_lsq_mode(*args, **kwargs):
        lsq_mode.append(1)
        return real_lsq_mode(*args, **kwargs)

    log = io.StringIO()
    _zero_counts(wrappers)
    train_lsq.load_weights_overlay, lsq.fused_lsq_codeword = checked_preload, counted_lsq_mode
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            results = train_lsq.main(argv)
    finally:
        train_lsq.load_weights_overlay, lsq.fused_lsq_codeword = real_preload, real_lsq_mode
    secs = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    launches = _counts(wrappers)
    steps = LSQ_TRAIN_EPOCHS * LSQ_TRAIN_STEPS
    val_batches = 8 * LSQ_TRAIN_EPOCHS
    expected = {key: 0 for key in _counts(wrappers)}
    expected.update(bd_fwd=13 * (steps + val_batches), bd_bwd=13 * steps,
                    codeword=72 * (2 * steps + val_batches),
                    **_conv_launches(forwards=val_batches, steps=steps))
    expected_lsq_mode = 72 * (steps + val_batches)
    row = results.get(f"lsqfib_n{LSQ_NBITS}", {})
    losses = [float(v) for v in re.findall(r"\| loss (\S+)", log.getvalue())]
    valid = [float(v) for v in re.findall(r"valid loss (\S+)", log.getvalue())]
    written = (out / "lsq_fibbinary_results.json").exists()
    finite = (bool(losses) and len(valid) == LSQ_TRAIN_EPOCHS
              and all(math.isfinite(v) for v in losses + valid + [row.get("final_val_nmse")]))
    preload_ok = (preload.get("weights_equal") and preload.get("step_sizes_kept")
                  and preload.get("step_sizes_not_from_loaded") and preload.get("layers") == 72)
    print(f"lsq train phase: cli.train_lsq {' '.join(argv)}: {secs:.1f} s; preload: "
          f"{preload.get('replaced')} entries replaced, equal to the checkpoint's "
          f"{preload.get('weights_equal')}, {preload.get('layers')} step sizes kept from the "
          f"init weights {preload.get('step_sizes_kept')}, none from the loaded weights "
          f"{preload.get('step_sizes_not_from_loaded')}; launches "
          f"{_launch_report(launches, expected)}, of the codeword launches LSQ mode "
          f"{len(lsq_mode)} (expected {expected_lsq_mode}) and snap mode "
          f"{launches['codeword'] - len(lsq_mode)} (expected {72 * steps}); train loss "
          f"{losses[-1] if losses else None}, valid loss {valid[-1] if valid else None}, "
          f"final_val_nmse {row.get('final_val_nmse')}, preload {row.get('preload')}; finite "
          f"{finite}, results JSON written {written}", flush=True)
    if not preload_ok:
        fail(f"the FP32 preload of the lsq train phase is wrong: {preload}")
    if launches != expected or len(lsq_mode) != expected_lsq_mode:
        fail(f"kernels launched {launches} times ({len(lsq_mode)} LSQ mode) in the lsq train "
             f"phase, not {expected} ({expected_lsq_mode})")
    if not (finite and written and row.get("preload") == pathlib.Path(checkpoint).name):
        fail("the lsq train phase's losses are not finite or its results JSON is wrong")
    return dict(argv=argv, seconds=secs, preload=preload, launches=launches,
                lsq_mode_launches=len(lsq_mode), losses=losses, valid_losses=valid, result=row)


# The quantization study (slice 11). QAT: the flagship's 72 weights
# transformed after every step at fraction QAT_FRACTION (proximal, wl 2, fl
# -2: experiments/qat_incremental.py's defaults), through the fixed grid and
# through the fibbinary codebook; pruning at PRUNE_LEVELS with 4x1 blocks.
QAT_WL, QAT_FL, QAT_FRACTION = 2, -2, 0.7
PRUNE_LEVELS = (0.5, 0.9)
# The drivers' short recipes, from the cli phase's checkpoint, the kernels on.
DRIVER_STEPS, DRIVER_PRUNE_EPOCHS = 10, 2  # steps an epoch; the prune run's epochs
DRIVER_PTQ = ["--wl-min", "8", "--wl-max", "10", "--val-samples", "512"]
DRIVER_QAT = ["--codebook", "fibonacci", "--epochs-per-step", "1", "--steps-per-epoch",
              str(DRIVER_STEPS), "--train-samples", "1024"]
DRIVER_PRUNE = ["--epochs", str(DRIVER_PRUNE_EPOCHS), "--steps-per-epoch", str(DRIVER_STEPS),
                "--train-samples", "1024"]
DRIVER_COMMON = ["--snr", "20", "--calibrated", "--ue-speed-kmh", "5", "--use-pallas"]


def _plain_partial(torch, w, q, fraction, bounds):
    """The per-tensor plain path of a proximal partial transform, written
    out apart from the port's: ``q`` where ``|w - q|`` is at most its
    ``int32(float32 p * (n - 1))``-th smallest, then the clamp."""
    d = (w - q).abs()
    k = int((torch.tensor(fraction, dtype=torch.float32) * (d.numel() - 1)).item())
    return torch.where(d <= torch.sort(d.reshape(-1)).values[k], q, w).clamp(*bounds)


def phase_qat_prune(torch, wrappers, card):
    """One QAT step at the flagship through each grouped transform, fixed
    grid then fibbinary: the 72 tensors bit for bit with the per-tensor
    plain path from the same post-step weights, at least the fraction on
    the grid, Adam's state the same objects with the same values; the launch
    counts of 8-step chunks of QAT and of pruning (train step, then
    ``apply_pruning`` at 0.9); the chunks' samples/s in turns with plain
    FP32 training; ``apply_pruning`` on the card against the CPU at
    ``PRUNE_LEVELS``, and ``measured_sparsity`` against the block count."""
    import copy

    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.ops.cuda.quant import (
        fixed_point_quantize_reference,
        nearest_codeword_reference,
    )
    from channelestimationtransformer_torch.ops.prune import (
        apply_pruning,
        block_scores,
        measured_sparsity,
    )
    from channelestimationtransformer_torch.ops.quant import (
        FibbinaryPartialWeightQuant,
        FixedPointPartialWeightQuant,
        apply_weight_quant,
        assign_,
        build_weight_quant_settings,
        fibbinary_codebook,
    )
    from channelestimationtransformer_torch.train.trainer import create_train_state, train_step

    cfg, model, _, ds = _models_and_data(torch)
    batch = 256
    tc = TrainConfig(batch_size=batch, lr=1e-4)
    cb = torch.tensor(fibbinary_codebook(QAT_WL, QAT_FL), dtype=torch.float32, device="cuda")
    transforms = {
        "qat fixed": (FixedPointPartialWeightQuant(QAT_WL, QAT_FL), "fixed",
                      lambda w: fixed_point_quantize_reference(w, QAT_WL, QAT_FL),
                      (-(2.0 ** (QAT_WL - QAT_FL - 1)), 2.0 ** (QAT_WL - QAT_FL - 1) - 2.0 ** -QAT_FL)),
        "qat fibbinary": (FibbinaryPartialWeightQuant(QAT_WL, QAT_FL), "codeword",
                          lambda w: nearest_codeword_reference(w, cb),
                          (cb.min().item(), cb.max().item())),
    }
    paths = {name: copy.deepcopy(model) for name in (*transforms, "prune", "fp32")}
    states = {name: create_train_state(m, tc) for name, m in paths.items()}
    params = {name: dict(m.named_parameters()) for name, m in paths.items()}
    settings = {name: build_weight_quant_settings(paths[name].state_dict(), t[0])
                for name, t in transforms.items()}

    def step(name, gen):
        train_step(states[name], ds, batch_size=batch, label_len=cfg.label_len, generator=gen)
        with torch.no_grad():
            if name in transforms:
                assign_(params[name], apply_weight_quant(params[name], settings[name],
                                                         percentage=QAT_FRACTION))
            elif name == "prune":
                assign_(params[name], apply_pruning(params[name], PRUNE_LEVELS[-1]))

    out = {}
    # (a) One step of each QAT path: the grouped transform against the plain
    # per-tensor path, the grid share, Adam's state.
    for name, (_, key, snap, bounds) in transforms.items():
        gen = torch.Generator(device="cuda").manual_seed(11)
        train_step(states[name], ds, batch_size=batch, label_len=cfg.label_len, generator=gen)
        p = params[name]
        names = sorted(settings[name].settings)
        before = {n: p[n].detach().clone() for n in names}
        adam = {n: states[name].optimizer.state[p[n]] for n in p}
        adam_values = {n: {k: v.clone() for k, v in a.items()} for n, a in adam.items()}
        objects = [id(v) for v in p.values()]
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        with torch.no_grad():
            assign_(p, apply_weight_quant(p, settings[name], percentage=QAT_FRACTION))
        torch.cuda.synchronize()
        launches = _counts(wrappers)
        want = {n: _plain_partial(torch, before[n], snap(before[n]), QAT_FRACTION, bounds)
                for n in names}
        equal = all(torch.equal(p[n].detach(), want[n]) for n in names)
        on_grid = sum((p[n].detach() == snap(before[n]).clamp(*bounds)).sum().item()
                      for n in names) / sum(p[n].numel() for n in names)
        kept = (objects == [id(v) for v in p.values()]
                and all(states[name].optimizer.state[p[n]] is adam[n]
                        and all(torch.equal(adam[n][k], adam_values[n][k]) for k in adam[n])
                        for n in p))
        expected = {k: 0 for k in launches} | {key: 1}
        print(f"{name} step (proximal, wl {QAT_WL}, fl {QAT_FL}, fraction {QAT_FRACTION}): "
              f"{len(names)} tensors, transform launches {_launch_report(launches, expected)}; "
              f"equal to the per-tensor plain path bit for bit {equal}; on the grid "
              f"{on_grid:.4f} (at least {QAT_FRACTION}); parameters and Adam's moments the same "
              f"objects, moments unchanged {kept}", flush=True)
        if launches != expected or len(names) != 72:
            fail(f"the {name} transform launched {launches}, not {expected}")
        if not (equal and on_grid >= QAT_FRACTION and kept):
            fail(f"the {name} transform differs from the per-tensor plain path or lost Adam's "
                 f"state")
        out[name] = dict(transform_launches=launches, on_grid=on_grid)

    # (b) Launches of 8-step chunks, then samples/s of the chunks in turns.
    def run(name, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(TRAIN_STEPS):
            step(name, gen)

    per_step = {"qat fixed": dict(fixed=1), "qat fibbinary": dict(codeword=1), "prune": {},
                "fp32": {}}
    for name, extra in per_step.items():
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        run(name, 5)
        torch.cuda.synchronize()
        launches = _counts(wrappers)
        per = dict(bd_fwd=13, bd_bwd=13) | _conv_launches(steps=1) | extra
        expected = {k: TRAIN_STEPS * per.get(k, 0) for k in launches}
        finite = all(torch.isfinite(v).all().item() for v in params[name].values())
        print(f"{name} chunk: {TRAIN_STEPS} steps x {batch}, launches "
              f"{_launch_report(launches, expected)}; weights finite {finite}", flush=True)
        if launches != expected or not finite:
            fail(f"the {name} chunk launched {launches}, not {expected}, or went non-finite")
        out.setdefault(name, {})["launches"] = launches
    times = _alternate(torch, lambda name, i: run(name, 100 + i), rounds=6, names=tuple(per_step))
    samples = TRAIN_STEPS * batch
    for name, ts in times.items():
        med = statistics.median(ts[2:])
        out[name].update(samples_per_s=samples / med, chunk_ms=[t * 1e3 for t in ts[2:]])
        print(f"{name:13s} chunk: {samples / med:.1f} samples/s (median of {len(ts) - 2} chunks "
              f"of {TRAIN_STEPS} steps x {batch}, {med * 1e3:.3f} ms; "
              f"{out[name]['samples_per_s'] / (samples / statistics.median(times['fp32'][2:])):.3f}"
              f"x plain FP32 training in the same turns) on {card}", flush=True)

    # (c) apply_pruning on the card against the CPU; measured_sparsity
    # against the block count: k + 1 blocks of 4 a weight, and with them
    # any block whose score ties the threshold (pruned too: blocks scoring
    # above it stay), each weight's scores taken alone by block_scores.
    weights = dict(paths["fp32"].named_parameters())
    for level in PRUNE_LEVELS:
        with torch.no_grad():
            got = apply_pruning(weights, level)
            want = apply_pruning({n: w.detach().cpu() for n, w in weights.items()}, level)
        equal = all(torch.equal(got[n].cpu(), want[n]) for n in weights)
        f32 = torch.tensor(level, dtype=torch.float32)
        blocks, pruned, ties = [], 0, 0
        for n, w in weights.items():
            if got[n] is w:
                continue
            scores = block_scores(w.detach()).reshape(-1)
            k = int((f32 * (scores.numel() - 1)).item())
            at_or_below = int((scores <= torch.sort(scores).values[k]).sum())
            blocks.append(w.numel() // 4)
            pruned += at_or_below
            ties += at_or_below - (k + 1)
        predicted = 4 * pruned / (4 * sum(blocks))
        measured = measured_sparsity(got)
        print(f"prune {level}: {len(blocks)} weights on the card equal to the CPU's bit for bit "
              f"(masks and values) {equal}; measured_sparsity {measured!r} (the block count "
              f"gives {predicted!r}, {ties} block(s) tied at a threshold)", flush=True)
        if not (equal and measured == predicted and len(blocks) == 72):
            fail(f"pruning at {level} differs between the card and the CPU or from its block "
                 f"count")
        out[f"prune_{level}"] = dict(measured_sparsity=measured, predicted=predicted, ties=ties)
    return out


def phase_study_drivers(torch, wrappers, checkpoint):
    """``cli.ptq_sweep``, ``cli.qat_incremental`` and ``cli.prune`` in this
    process on their short recipes from ``checkpoint``: the launch counts
    the recipes give (a quantization one fixed-point launch, a QAT step one
    codeword launch, 13 bd forward and backward a step, 13 bd forward a
    validation batch, the conv kernels' of :func:`_conv_launches`), finite
    losses and the files written. The drivers'
    checkpoints (~16 MB each) are deleted once seen."""
    from channelestimationtransformer_torch.cli import prune, ptq_sweep, qat_incremental

    fractions = len(qat_incremental.SCHEDULES["proximal"])
    qat_steps, prune_steps = fractions * DRIVER_STEPS, DRIVER_PRUNE_EPOCHS * DRIVER_STEPS
    study = OUT / "study"
    runs = [
        ("ptq_sweep", ptq_sweep, [*DRIVER_PTQ, "--out", str(study / "ptq_results.json")],
         dict(fixed=2 * 3, bd_fwd=13 * 8 * (1 + 2 * 3), **_conv_launches(8 * (1 + 2 * 3))),
         ["ptq_results.json", "loss_list_nearest.pkl", "loss_list_stochastic.pkl"]),
        ("qat_incremental", qat_incremental, [*DRIVER_QAT, "--out", str(study)],
         dict(codeword=qat_steps, bd_fwd=13 * (qat_steps + 8 * fractions), bd_bwd=13 * qat_steps,
              **_conv_launches(8 * fractions, qat_steps)),
         ["qat_wl2_fl-2_proximal_partial_fibonacci.json",
          f"qat_wl2_fl-2_proximal_partial_fibonacci_{fractions}.pt"]),
        ("prune", prune, [*DRIVER_PRUNE, "--out", str(study)],
         dict(bd_fwd=13 * (prune_steps + 4 * DRIVER_PRUNE_EPOCHS), bd_bwd=13 * prune_steps,
              **_conv_launches(4 * DRIVER_PRUNE_EPOCHS, prune_steps)),
         ["prune_results.json", f"pruned_{DRIVER_PRUNE_EPOCHS}.pt"]),
    ]
    out = {}
    for name, cli, argv, counts, files in runs:
        argv = [*DRIVER_COMMON, *argv, "--checkpoint", str(checkpoint)]
        expected = {key: counts.get(key, 0) for key in _counts(wrappers)}
        log = io.StringIO()
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            result = cli.main(argv)
        secs = time.perf_counter() - t0
        print(log.getvalue(), end="", flush=True)
        launches = _counts(wrappers)
        values = (list(result.values()) if isinstance(result, dict) else result)
        losses = [v[1] if isinstance(v, (list, tuple)) else v["val_nmse"] for v in values]
        finite = bool(losses) and all(math.isfinite(v) for v in losses)
        written = all((study / f).exists() for f in files)
        for f in files:
            if f.endswith(".pt") and (study / f).exists():
                (study / f).unlink()
        print(f"driver phase: cli.{name} {' '.join(argv)}: {secs:.1f} s; launches "
              f"{_launch_report(launches, expected)}; {len(losses)} validation NMSEs, last "
              f"{losses[-1] if losses else None}; finite {finite}; files written {written}",
              flush=True)
        if launches != expected:
            fail(f"kernels launched {launches} times in cli.{name}, not {expected}")
        if not (finite and written):
            fail(f"cli.{name}'s losses are not finite or its files are missing")
        out[name] = dict(argv=argv, seconds=secs, launches=launches, val_nmse=losses)
    return out


# int8 serving, streaming, the baselines and their drivers.
INT8_MODES = ("w8a8", "weight_only")
# Kernel path against plain path inside the intercept, one batch: an NMSE
# between the two predictions, not an elementwise limit. ~1e-6 between the
# attention paths moves an activation across a rounding boundary now and then
# (W8A8: one code, 1/127 of the layer's max; weight-only: one bf16 step), and
# the moved value moves the next layers' roundings too. A limit a mode, from
# the card's readings at seed 0 with room above them: W8A8 8.0e-4 apart (its
# rounding noise against f32 is 9.5e-4: per-tensor codes cascade), weight-only
# 1.4e-5 (noise 3.5e-4). The same limits hold the card's kernel path against
# the same model served on the CPU, one batch (read: 7.8e-4 and 1.6e-5).
INT8_VS_PLAIN_NMSE = {"w8a8": 2e-3, "weight_only": 1e-4}
# One served layer, card against CPU on the same input: W8A8 (int32 GEMM,
# rescale, bias) bit for bit; weight-only, which sums its bf16 products in
# another order, within this fraction of its max (read: up to 3.4e-7).
INT8_LAYER_TOL = 1e-6
STREAM_BLOCK, STREAM_SLOTS, STREAM_BATCH = 5, 100, 128
STREAM_TOL = 1e-5  # the last block's prediction against the offline forward, max abs
BASELINE_TOL = 1e-4  # card against CPU, one batch, max|diff| / max|CPU| (TF32 off)
RECURRENT_STEPS = 8


def phase_int8_path(torch, wrappers, gemms, card):
    """The flagship (kernels on, seed 0) served in int8: the table built on
    the card against the one built on the CPU from the same weights, bit
    for bit; ``eval_chunk`` of 8 batches of 256 in each mode inside
    ``serving_intercept`` (and f32 without it), with 77 table entries hit,
    13 bd launches a batch and one GEMM a served layer (W8A8:
    ``int8_matmul``, cuBLAS int8; weight-only: ``bf16_matmul_f32``); one
    layer of each GEMM shape against the CPU (W8A8 bit for bit, weight-only
    ``INT8_LAYER_TOL``); one batch
    against the plain attention path inside the intercept and against the
    same model served on the CPU (``INT8_VS_PLAIN_NMSE``); samples/s of the
    three modes in turns."""
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.ops.quant import serving
    from channelestimationtransformer_torch.train.trainer import eval_chunk

    cfg, model, plain, ds = _models_and_data(torch)
    cpu = copy.deepcopy(model).cpu()
    table = serving.build_int8_table(model)
    cpu_table = serving.build_int8_table(cpu)
    equal = (set(table) == set(cpu_table) and all(
        torch.equal(table[k][f].cpu(), cpu_table[k][f]) for k in table
        for f in ("w_q", "w_scale", "bias")))
    print(f"int8 table: {len(table)} entries ({sum('distil' in k for k in table)} distil "
          f"convs), card equal to CPU bit for bit {equal}", flush=True)
    if len(table) != 77 or not equal:
        fail("the int8 table is not 77 entries equal to the CPU's")
    n_batches, batch = 8, 256

    # One served layer of each GEMM shape (k, n), card against CPU, on
    # 256 x 90 rows (the first encoder layer's).
    gen = torch.Generator(device="cuda").manual_seed(9)
    layers = {}
    for key, entry in table.items():
        layers.setdefault(tuple(entry["w_q"].shape), key)
    layer_errs = {}
    for (k, n), key in sorted(layers.items()):
        x = torch.randn(batch * cfg.seq_len, k, generator=gen, device="cuda")
        x_q = torch.randint(-127, 128, (batch * cfg.seq_len, k), generator=gen,
                            device="cuda", dtype=torch.int8)
        gemm_equal = torch.equal(serving.int8_matmul(x_q, table[key]["w_q"]).cpu(),
                                 torch._int_mm(x_q.cpu(), cpu_table[key]["w_q"]))
        errs = {}
        for mode, apply in (("w8a8", serving.int8_dense_apply),
                            ("weight_only", serving.int8_dense_weight_only_apply)):
            want = apply(x.cpu(), cpu_table[key])
            errs[mode] = ((apply(x, table[key]).cpu() - want).abs().max()
                          / want.abs().max()).item()
        ok = gemm_equal and errs["w8a8"] == 0 and errs["weight_only"] <= INT8_LAYER_TOL
        print(f"int8 layer {key} ({k} x {n}, {batch * cfg.seq_len} rows), card vs CPU: int32 "
              f"GEMM equal bit for bit {gemm_equal}; max_abs/max W8A8 {errs['w8a8']:.3e} "
              f"(limit 0), weight-only {errs['weight_only']:.3e} (limit {INT8_LAYER_TOL}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the int8 layer {key} on the card disagrees with the CPU")
        layer_errs[f"{k}x{n}"] = dict(layer=key, gemm_equal=gemm_equal, **errs)

    def run(mode, seed, m=model, hits=None):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with (serving.serving_intercept(m, table, hits, mode=mode) if mode != "f32"
              else contextlib.nullcontext()):
            return eval_chunk(m, ds, num_batches=n_batches, batch_size=batch,
                              label_len=cfg.label_len, generator=gen)

    out = {"entries": len(table), "layers_vs_cpu": layer_errs}
    for mode in ("f32",) + INT8_MODES:
        hits = set()
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        _zero_counts(gemms)
        res = run(mode, 1, hits=hits)
        torch.cuda.synchronize()
        launches, gemm = _counts(wrappers), _counts(gemms)
        # Served in int8 the distil convs run the int8 conv; the embeddings'
        # stay float32 on the conv kernels.
        expected = ({key: 0 for key in launches} | dict(bd_fwd=13 * n_batches)
                    | _conv_launches(forwards=n_batches, convs=7 if mode == "f32" else 2))
        want_gemm = {key: 0 for key in gemms}
        if mode != "f32":
            want_gemm["int8" if mode == "w8a8" else "bf16_f32"] = 77 * n_batches
        nmse = res["nmse"].item()
        print(f"int8 eval path, {mode}: eval_chunk {n_batches} x {batch}: nmse {nmse:.6f}, "
              f"{len(hits)} entries hit (expected {77 if mode != 'f32' else 0}), launches "
              f"{_launch_report(launches, expected)}; GEMMs int8 {gemm['int8']}, bf16 -> f32 "
              f"{gemm['bf16_f32']} (expected {want_gemm['int8']}, {want_gemm['bf16_f32']})",
              flush=True)
        if launches != expected or gemm != want_gemm:
            fail(f"the int8 eval path ({mode}) launched {launches}, {gemm}")
        if len(hits) != (77 if mode != "f32" else 0) or not math.isfinite(nmse):
            fail(f"the int8 eval path ({mode}) hit {len(hits)} entries, nmse {nmse}")
        out[mode] = dict(nmse=nmse, launches=launches, gemm_launches=gemm, hits=len(hits))

    x_enc, x_dec, _ = make_batch(ds, batch, cfg.label_len,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        f32 = {"kernel": model(x_enc, x_dec), "plain": plain(x_enc, x_dec)}
        for mode in INT8_MODES:
            preds = {}
            for path, m, tab, xs in (("kernel", model, table, (x_enc, x_dec)),
                                     ("plain", plain, table, (x_enc, x_dec)),
                                     ("cpu", cpu, cpu_table, (x_enc.cpu(), x_dec.cpu()))):
                with serving.serving_intercept(m, tab, mode=mode):
                    preds[path] = m(*xs)
            rel, nm = _rel_nmse(preds["kernel"], preds["plain"])
            cpu_rel, cpu_nm = _rel_nmse(preds["kernel"].cpu(), preds["cpu"])
            noise = {path: _rel_nmse(preds[path], f32[path])[1] for path in f32}
            limit = INT8_VS_PLAIN_NMSE[mode]
            ok = bool(torch.isfinite(preds["kernel"]).all()) and max(nm, cpu_nm) <= limit
            print(f"int8 eval path, {mode}, one batch inside the intercept: kernel path vs "
                  f"plain attention path max_abs/max {rel:.3e}, nmse {nm:.3e}; vs the CPU "
                  f"max_abs/max {cpu_rel:.3e}, nmse {cpu_nm:.3e} (limit {limit:.1e}) "
                  f"{'ok' if ok else 'MISMATCH'}; nmse against the f32 prediction: kernel "
                  f"path {noise['kernel']:.3e}, plain path {noise['plain']:.3e}", flush=True)
            if not ok:
                fail(f"int8 {mode}: the kernel path disagrees with the plain path or the CPU")
            out[mode].update(vs_plain_max_rel=rel, vs_plain_nmse=nm, vs_plain_limit=limit,
                             vs_cpu_max_rel=cpu_rel, vs_cpu_nmse=cpu_nm,
                             vs_f32_nmse=noise["kernel"], plain_vs_f32_nmse=noise["plain"])

    times = _alternate(torch, lambda mode, i: run(mode, 100 + i), rounds=8,
                       names=("f32",) + INT8_MODES)
    rates = {mode: n_batches * batch / statistics.median(ts[2:]) for mode, ts in times.items()}
    for mode, rate in rates.items():
        out[mode].update(samples_per_s=rate, chunk_ms=[t * 1e3 for t in times[mode][2:]],
                         vs_f32=rate / rates["f32"])
        print(f"int8 eval {mode:11s}: {rate:.1f} samples/s, {rate / rates['f32']:.3f}x f32 "
              f"(median of {len(times[mode]) - 2} chunks of {n_batches * batch}, in turns) on "
              f"{card}", flush=True)
    return out


def phase_streaming(torch, wrappers, card):
    """``streaming_rollout`` of the flagship (kernels on, seed 0) over a
    stream of 128 x 100 slots in blocks of 5: 20 blocks, 13 bd launches a
    block; every block's prediction against the plain path's rollout of the
    same stream (``MAIN_TOL``), the last one against the offline forward of
    the same window (``STREAM_TOL``); blocks/s of the kernel and plain paths
    in turns."""
    from channelestimationtransformer_torch.models.streaming import streaming_rollout

    cfg, model, plain, _ = _models_and_data(torch, samples=16)
    gen = torch.Generator(device="cuda").manual_seed(8)
    stream = torch.randn(STREAM_BATCH, STREAM_SLOTS, cfg.enc_in, generator=gen, device="cuda")
    n_blocks = STREAM_SLOTS // STREAM_BLOCK
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    with torch.no_grad():
        preds = streaming_rollout(model, cfg, stream, STREAM_BLOCK)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    expected = ({key: 0 for key in launches} | dict(bd_fwd=13 * n_blocks)
                | _conv_launches(forwards=n_blocks))
    window = stream[:, STREAM_SLOTS - cfg.seq_len:]
    x_dec = torch.cat([window[:, -cfg.label_len:],
                       window.new_zeros(STREAM_BATCH, cfg.pred_len, cfg.enc_in)], dim=1)
    with torch.no_grad():
        offline = model(window.contiguous(), x_dec)
        plain_preds = streaming_rollout(plain, cfg, stream, STREAM_BLOCK)
    err = (preds[-1] - offline).abs().max().item()
    plain_err = (preds - plain_preds).abs().max().item()
    ok = (tuple(preds.shape) == (n_blocks, STREAM_BATCH, cfg.pred_len, cfg.enc_in)
          and bool(torch.isfinite(preds).all()) and err <= STREAM_TOL
          and torch.allclose(preds, plain_preds, rtol=MAIN_TOL[0], atol=MAIN_TOL[1]))
    print(f"streaming path: {STREAM_BATCH} streams x {STREAM_SLOTS} slots in blocks of "
          f"{STREAM_BLOCK}: {n_blocks} blocks, launches {_launch_report(launches, expected)}; "
          f"every block vs the plain path's rollout: max_abs {plain_err:.3e} (rtol "
          f"{MAIN_TOL[0]}, atol {MAIN_TOL[1]}); last block vs the offline forward of its "
          f"window: max_abs {err:.3e} (limit {STREAM_TOL}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if launches != expected or not ok:
        fail("the streaming path's launches, its plain rollout or its full-window prediction "
             "are off")
    models = {"kernel": model, "plain": plain}

    def rollout(path, _):
        with torch.no_grad():
            streaming_rollout(models[path], cfg, stream, STREAM_BLOCK)
    times = _alternate(torch, rollout, rounds=6)
    out = dict(launches=launches, full_window_max_abs=err, vs_plain_max_abs=plain_err,
               blocks=n_blocks)
    for path, ts in times.items():
        rate = n_blocks / statistics.median(ts[2:])
        out[f"{path}_blocks_per_s"] = rate
        print(f"streaming {path:6s} path: {rate:.1f} blocks/s of {STREAM_BATCH} streams "
              f"(median of {len(ts) - 2} rollouts of {n_blocks}, in turns) on {card}",
              flush=True)
    return out


def _vs_cpu(torch, model, fn, *inputs):
    """max|card - CPU| / max|CPU| of ``fn(model, *inputs)`` with the same
    weights on the CPU, float32, TF32 off on the card."""
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        got = fn(model, *inputs)
        want = fn(cpu, *(x.cpu() for x in inputs))
    return ((got.cpu() - want).abs().max() / want.abs().max()).item()


def phase_baselines(torch, wrappers, card):
    """``TransformerConfig()`` (no kernel route, as in JAX) in eval and
    training chunks of 8 x 256 on the flagship's data; each of lstm, gru and
    rnn (``cli/comparison.py``'s ``RecurrentConfig``) in a chunk of 8
    teacher-forced Adam steps at batch 64 and one 5-step rollout at batch 256
    on windows of 25 + 5 slots; each against the same model on the CPU on
    one batch (``BASELINE_TOL``); no attention or quant kernel launched, the
    Transformer's two embeddings on the conv kernels."""
    from channelestimationtransformer_torch.core.config import (
        RecurrentConfig,
        TrainConfig,
        TransformerConfig,
    )
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.data.windows import (
        WindowDataset,
        make_batch,
        sample_windows,
    )
    from channelestimationtransformer_torch.models import build_recurrent, build_transformer
    from channelestimationtransformer_torch.train.trainer import (
        create_train_state,
        eval_chunk,
        train_chunk,
    )

    tcfg = TransformerConfig()
    ds = _card_data(torch, tcfg.seq_len, tcfg.pred_len, samples=16384)
    out = {}
    model = build_transformer(tcfg, device="cuda", seed=0)
    x_enc, x_dec, _ = make_batch(ds, 256, tcfg.label_len,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
    rel = _vs_cpu(torch, model, lambda m, a, b: m(a, b), x_enc, x_dec)
    state = create_train_state(model, TrainConfig())
    _zero_counts(wrappers)

    def chunk(kind, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if kind == "eval":
            return eval_chunk(model, ds, num_batches=8, batch_size=256,
                              label_len=tcfg.label_len, generator=gen)["nmse"]
        return train_chunk(state, ds, num_steps=8, batch_size=256, label_len=tcfg.label_len,
                           generator=gen)["loss_sum"] / 8
    values = {kind: chunk(kind, 1).item() for kind in ("eval", "train")}
    times = _alternate(torch, lambda kind, i: chunk(kind, 100 + i), rounds=6,
                       names=("eval", "train"))
    rates = {kind: 8 * 256 / statistics.median(ts[2:]) for kind, ts in times.items()}
    launches = _counts(wrappers)
    # 7 eval and 7 training chunks of 8 (the first of each, then 6 rounds).
    expected = {key: 0 for key in launches} | _conv_launches(
        forwards=7 * 8, steps=7 * 8, convs=2, distil=0)
    ok = rel <= BASELINE_TOL and all(math.isfinite(v) for v in values.values())
    print(f"baseline transformer (TransformerConfig(), no attention kernel route): one batch "
          f"card vs CPU max_abs/max {rel:.3e} (limit {BASELINE_TOL}) {'ok' if ok else 'MISMATCH'}; "
          f"eval nmse {values['eval']:.6f}, train loss {values['train']:.6f}; eval "
          f"{rates['eval']:.1f}, train {rates['train']:.1f} samples/s (chunks of 8 x 256, in "
          f"turns); launches {_launch_report(launches, expected)} on {card}", flush=True)
    if not ok or launches != expected:
        fail("the Transformer baseline disagrees with the CPU or launched the wrong kernels")
    out["transformer"] = dict(vs_cpu=rel, **values, eval_samples_per_s=rates["eval"],
                              train_samples_per_s=rates["train"])

    windows = WindowDataset(h=ds.h, seq_len=25, pred_len=5, snr_db=ds.snr_db, device="cuda")
    for cell in ("lstm", "gru", "rnn"):
        rcfg = RecurrentConfig(features=16, input_size=128, hidden_size=256, num_layers=2,
                               cell=cell)
        model = build_recurrent(rcfg, device="cuda", seed=0)
        clean, noisy, h_seq, h_pred = sample_windows(
            windows, 256, generator=torch.Generator(device="cuda").manual_seed(3))
        rel_fwd = _vs_cpu(torch, model, lambda m, x: m(x), noisy)
        rel_roll = _vs_cpu(torch, model, lambda m, x: m.rollout(x, 5), h_seq)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def steps(seed):
            model.train()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            for _ in range(RECURRENT_STEPS):
                c, n, _, _ = sample_windows(windows, 64, generator=gen)
                loss = nmse(model(n)[:, -10:], c[:, -10:])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            return loss

        def rollout(seed):
            model.eval()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            _, _, x, y = sample_windows(windows, 256, generator=gen)
            with torch.no_grad():
                return nmse(model.rollout(x, 5), y)
        loss, roll = steps(1).item(), rollout(2).item()
        times = _alternate(torch, lambda kind, i: (steps if kind == "train" else rollout)(
            100 + i), rounds=6, names=("train", "rollout"))
        rates = {"train": RECURRENT_STEPS * 64 / statistics.median(times["train"][2:]),
                 "rollout": 256 / statistics.median(times["rollout"][2:])}
        ok = (max(rel_fwd, rel_roll) <= BASELINE_TOL and math.isfinite(loss)
              and math.isfinite(roll))
        print(f"baseline {cell}: card vs CPU max_abs/max forward {rel_fwd:.3e}, rollout "
              f"{rel_roll:.3e} (limit {BASELINE_TOL}) {'ok' if ok else 'MISMATCH'}; "
              f"{RECURRENT_STEPS} Adam steps x 64: loss {loss:.6f}, {rates['train']:.1f} "
              f"samples/s; 5-step rollout x 256: nmse {roll:.6f}, {rates['rollout']:.1f} "
              f"samples/s (in turns) on {card}", flush=True)
        if not ok:
            fail(f"the {cell} baseline disagrees with the CPU or is not finite")
        out[cell] = dict(vs_cpu_forward=rel_fwd, vs_cpu_rollout=rel_roll, train_loss=loss,
                         rollout_nmse=roll, train_samples_per_s=rates["train"],
                         rollout_samples_per_s=rates["rollout"])
    return out


# Their drivers, cut: cli.int8_serving over 512 samples and 2 batches
# (its latency loop, 12 x 20 forwards a mode, is the JAX driver's and not
# cut), cli.train_streaming at its defaults, cli.comparison with 10 steps a
# recurrent model, one epoch (100 steps, the driver's) a Trainer model, 1,024
# samples and two SNRs.
INT8_DRIVER_BATCHES = 2
INT8_DRIVER = ["--snr", "20", "--calibrated", "--ue-speed-kmh", "5", "--val-samples", "512",
               "--batches", str(INT8_DRIVER_BATCHES)]
STREAM_DRIVER = ["--snr", "20", "--calibrated", "--ue-speed-kmh", "5"]
COMPARISON_SNRS = ("12", "21")
COMPARISON_DRIVER = ["--steps", "10", "--epochs", "1", "--train-samples", "1024",
                     "--snr-sweep", *COMPARISON_SNRS, "--calibrated", "--ue-speed-kmh", "5"]


def phase_serving_drivers(torch, wrappers, gemms, checkpoint):
    """``cli.int8_serving``, ``cli.train_streaming`` and ``cli.comparison``
    in this process, the first two from ``checkpoint``: their launch counts
    (bd 13 a forward; one GEMM a served layer; the comparison's Informer 13
    forward and backward a step; the conv kernels' of :func:`_conv_launches`),
    finite results and files."""
    from channelestimationtransformer_torch.cli import comparison, int8_serving, train_streaming

    folder = OUT / "serving_drivers"
    forwards = 3 * INT8_DRIVER_BATCHES + 3 * (2 + 10) * 20  # accuracy + latency, 3 modes
    served = INT8_DRIVER_BATCHES + (2 + 10) * 20  # a mode's forwards
    n_snr = len(COMPARISON_SNRS)
    runs = [
        ("int8_serving", int8_serving,
         [*INT8_DRIVER, "--checkpoint", str(checkpoint), "--out",
          str(folder / "int8_serving.json")],
         # the conv kernels: 7 a float32 forward, 2 (the embeddings) an int8 one
         dict(bd_fwd=13 * forwards, **_conv_launches(served, convs=7 + 2 + 2)),
         dict(int8=77 * served, bf16_f32=77 * served),
         lambda r: [r["nmse_f32"], r["nmse_int8"], r["nmse_int8_wo"], r["nmse_delta_db"]]),
        ("train_streaming", train_streaming,
         [*STREAM_DRIVER, "--checkpoint", str(checkpoint), "--out",
          str(folder / "streaming_results.json")],
         dict(bd_fwd=13 * STREAM_SLOTS // STREAM_BLOCK,
              **_conv_launches(STREAM_SLOTS // STREAM_BLOCK)), {},
         lambda r: r["per_block_nmse"] + [r["warm_window_nmse"]]),
        ("comparison", comparison, [*COMPARISON_DRIVER, "--out", str(folder / "comparison")],
         # the Informer's 7 convs and the Transformer's 2 embeddings, each model
         # 100 steps and 8 + 8 a SNR validation batches
         dict(bd_fwd=13 * (100 + 8 + 8 * n_snr), bd_bwd=13 * 100,
              **_conv_launches(8 + 8 * n_snr, 100, convs=7 + 2)), {},
         lambda r: [v for sweep in r.values() for row in sweep.values() for v in row]),
    ]
    out = {}
    for name, cli, argv, counts, gemm_counts, values in runs:
        expected = {key: counts.get(key, 0) for key in _counts(wrappers)}
        want_gemm = {key: gemm_counts.get(key, 0) for key in gemms}
        log = io.StringIO()
        _zero_counts(wrappers)
        _zero_counts(gemms)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            result = cli.main(argv)
        secs = time.perf_counter() - t0
        print(log.getvalue(), end="", flush=True)
        launches, gemm = _counts(wrappers), _counts(gemms)
        vals = values(result)
        finite = bool(vals) and all(math.isfinite(v) for v in vals)
        print(f"driver phase: cli.{name} {' '.join(argv)}: {secs:.1f} s; launches "
              f"{_launch_report(launches, expected)}; GEMMs {gemm} (expected {want_gemm}); "
              f"{len(vals)} values, finite {finite}", flush=True)
        if launches != expected or gemm != want_gemm:
            fail(f"cli.{name} launched {launches}, {gemm}; expected {expected}, {want_gemm}")
        if not finite:
            fail(f"cli.{name}'s results are not finite")
        out[name] = dict(argv=argv, seconds=secs, launches=launches, gemm_launches=gemm,
                         result=result)
    written = [folder / "int8_serving.json", folder / "streaming_results.json",
               folder / "comparison" / "comparison.json",
               *(folder / "comparison" / f"loss_{m}.pkl"
                 for m in ("rnn", "gru", "lstm", "transformer", "informer"))]
    if not all(f.exists() for f in written):
        fail("a serving, streaming or comparison driver's file is missing")
    return out


# The link simulation (sim/), card against CPU on the same channels and
# injected draws. Limits set from two runs' card readings (chiprun_out/
# chip_smoke.json, "link"), about 4x over them: the decoders' LLRs within
# LINK_LLR_TOL of their max (read 9.7e-7 conv, 1.16e-6 LDPC), SE within
# LINK_SE_TOL relative (read 4.6e-7); uncoded BER within LINK_BER_TOL
# absolute at every Eb/N0, 2 bits of a call's 131,072 (read 0); the Viterbi
# and LDPC bits from identical LLRs bit for bit (read 0: the same IEEE
# operations in the same order on both devices).
LINK_B = 256
LINK_EBNO = (-4.0, -2.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0)
LINK_BER_TOL = 2 / (LINK_B * 512)
LINK_SE_TOL = 2e-6
LINK_LLR_TOL = 5e-6
LINK_BITS_TOL = 0
# (name, fec, csi, domain, symbols a stream): the e2e driver's five runs.
LINK_VARIANTS = [("uncoded", None, "perfect", "freq", 128), ("ls csi", None, "ls", "freq", 128),
                 ("time domain", None, "perfect", "time", 128),
                 ("conv", "conv", "perfect", "freq", 128), ("ldpc", "ldpc", "perfect", "freq", 162)]


def _link_draws(torch, fec, csi, domain, n_sym, seed):
    """The payload and unit complex noise of one link call, drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    if fec == "ldpc":
        payload = torch.rand((LINK_B, 1, 324), generator=gen) < 0.5
    elif fec == "conv":
        payload = torch.rand((LINK_B, n_sym * 2 * 2 // 2 - 6), generator=gen) < 0.5
    else:
        payload = torch.rand((LINK_B, n_sym * 2 * 2), generator=gen) < 0.5
    f = n_sym if domain == "freq" else n_sym + n_sym // 4
    shape = (LINK_B, 2, 1 + (2 if csi == "ls" else 0), f)
    noise = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
    return {"info" if fec else "bits": payload, "noise": noise}


def phase_link(torch, card):
    """``sim/``'s link on the card against the CPU: the e2e driver's five
    variants at its eight Eb/N0 points on 256 channels (2 x 4, precoded on a
    perturbed copy), the same draws injected on both; the decoders' LLRs; the
    Viterbi and LDPC decoders on the CPU's LLRs; SE; the card's seconds."""
    from channelestimationtransformer_torch.sim import coding, ldpc, link, precoding

    gen = torch.Generator().manual_seed(21)
    shape = (LINK_B, 2, 4)
    h = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
    h = h / math.sqrt(2.0)
    h_pre = h + 0.1 * torch.complex(torch.randn(shape, generator=gen),
                                    torch.randn(shape, generator=gen))
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            llr = args[1] if name == "ldpc" else args[0]
            seen.setdefault(name, []).append(llr)
            return fn(*args, **kwargs)
        return wrapped

    rows = {}
    for v, (name, fec, csi, domain, n_sym) in enumerate(LINK_VARIANTS):
        out = {}
        for device in ("cpu", "cuda"):
            seen.clear()
            link.viterbi_decode = spy("conv", coding.viterbi_decode)
            link.ldpc_decode = spy("ldpc", ldpc.ldpc_decode)
            bers, blers = [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, ebno in enumerate(LINK_EBNO):
                draws = _link_draws(torch, fec, csi, domain, n_sym, 100 * v + i)
                if fec:
                    ber, bler, total = link.simulate_coded_ber(
                        None, h, h_pre, ebno, link.LinkConfig(), n_sym, fec, csi, domain,
                        device=device, **draws)
                    blers.append(float(bler))
                else:
                    ber, total = link.simulate_ber(None, h, h_pre, ebno, link.LinkConfig(),
                                                   n_sym, csi, domain, device=device, **draws)
                bers.append(float(ber))
            torch.cuda.synchronize()
            out[device] = dict(ber=bers, bler=blers, seconds=time.perf_counter() - t0,
                               total=total, llr=list(seen.get(fec, [])))
            link.viterbi_decode, link.ldpc_decode = coding.viterbi_decode, ldpc.ldpc_decode
        cpu, gpu = out["cpu"], out["cuda"]
        ber_diff = max(abs(a - b) for a, b in zip(cpu["ber"], gpu["ber"]))
        row = dict(ber_cpu=cpu["ber"], ber_cuda=gpu["ber"], bler_cpu=cpu["bler"],
                   bler_cuda=gpu["bler"], ber_max_abs_diff=ber_diff,
                   seconds_cuda=gpu["seconds"], seconds_cpu=cpu["seconds"],
                   bits_per_s_cuda=len(LINK_EBNO) * gpu["total"] / gpu["seconds"])
        if fec:
            llr_err = max(float((g.cpu() - c).abs().max() / c.abs().max())
                          for c, g in zip(cpu["llr"], gpu["llr"]))
            # The decoders on identical LLRs (the CPU's), card against CPU.
            flipped = n_bits = 0
            for c in cpu["llr"]:
                if fec == "conv":
                    n = c.shape[-1] // 2 - (coding.K - 1)
                    a, b = coding.viterbi_decode(c, n), coding.viterbi_decode(c.cuda(), n)
                else:
                    code = ldpc.make_qc_ldpc()
                    a, b = ldpc.ldpc_decode(code, c), ldpc.ldpc_decode(code, c.cuda())
                flipped += int((a != b.cpu()).sum())
                n_bits += a.numel()
            row.update(llr_max_abs_over_max=llr_err, decoded_bits=n_bits,
                       decoded_bits_differing=flipped)
            print(f"link {name} (B {LINK_B}, {n_sym} symbols x 2 streams, {fec}), card vs cpu: "
                  f"coded BER max |diff| {ber_diff:.3e}, BLER {gpu['bler']} vs {cpu['bler']}; "
                  f"LLRs max_abs/max {llr_err:.3e} (limit {LINK_LLR_TOL}); {fec} decoder on "
                  f"identical LLRs: {flipped} of {n_bits} bits differ (limit "
                  f"{LINK_BITS_TOL}) | card {gpu['seconds']:.3f} s for "
                  f"{len(LINK_EBNO)} calls, {row['bits_per_s_cuda']:,.0f} bits/s; cpu "
                  f"{cpu['seconds']:.3f} s | {card}", flush=True)
            if not llr_err <= LINK_LLR_TOL:
                fail(f"link {name}: LLRs card vs cpu {llr_err:.3e} > {LINK_LLR_TOL}")
            if flipped > LINK_BITS_TOL * n_bits:
                fail(f"link {name}: {flipped} of {n_bits} decoded bits differ on identical LLRs")
        else:
            print(f"link {name} (B {LINK_B}, {n_sym} symbols x 2 streams, {csi} csi, {domain}), "
                  f"card vs cpu: BER max |diff| {ber_diff:.3e} (limit {LINK_BER_TOL:.3e}) | card "
                  f"{gpu['seconds']:.3f} s for {len(LINK_EBNO)} calls, "
                  f"{row['bits_per_s_cuda']:,.0f} bits/s; cpu {cpu['seconds']:.3f} s | {card}",
                  flush=True)
            if not ber_diff <= LINK_BER_TOL:
                fail(f"link {name}: BER card vs cpu differs by {ber_diff:.3e}")
        if not all(math.isfinite(x) for x in gpu["ber"] + gpu["bler"]):
            fail(f"link {name}: a BER is not finite on the card")
        rows[name] = row
    se = {dev: precoding.precoded_spectral_efficiency(h.to(dev), h_pre.to(dev), 100.0).cpu()
          for dev in ("cpu", "cuda")}
    se_err = float(((se["cuda"] - se["cpu"]).abs() / se["cpu"].abs()).max())
    print(f"link SE (B {LINK_B}, precoded on the perturbed copy, SNR 100), card vs cpu: "
          f"max relative |diff| {se_err:.3e} (limit {LINK_SE_TOL}); mean {float(se['cuda'].mean()):.4f} "
          f"vs {float(se['cpu'].mean()):.4f} b/s/Hz", flush=True)
    if not se_err <= LINK_SE_TOL:
        fail(f"link SE card vs cpu {se_err:.3e} > {LINK_SE_TOL}")
    rows["se_max_rel_diff"] = se_err
    return rows


# The e2e driver in the five variants of experiments/round2_queue.sh:30-38 at
# its defaults (batch 256, eight Eb/N0, three CSI sources) from the cli phase's
# checkpoint: the predictor's one forward is 13 bd forward launches a run.
E2E_COMMON = ["--calibrated", "--ue-speed-kmh", "5"]
E2E_RUNS = [("uncoded", "e2e_results.json", []),
            ("coded_conv", "e2e_coded_conv.json", ["--coded", "--fec", "conv"]),
            ("coded_ldpc", "e2e_coded_ldpc.json", ["--coded", "--fec", "ldpc"]),
            ("ls_csi", "e2e_ls.json", ["--csi", "ls"]),
            ("time_domain", "e2e_time.json", ["--domain", "time"])]


def phase_e2e_drivers(torch, wrappers, card, checkpoint):
    """``cli.end_to_end_sim`` five times and ``cli.collect_e2e`` over them, in
    this process: 13 bd forward and 7 conv launches a run and none of the
    other kernels, finite rows, files written, seconds and Monte-Carlo
    bits/s."""
    from channelestimationtransformer_torch.cli import collect_e2e, end_to_end_sim

    folder = OUT / "e2e"
    expected = ({key: 0 for key in _counts(wrappers)} | dict(bd_fwd=13)
                | _conv_launches(forwards=1))
    out = {}
    for branch, fname, flags in E2E_RUNS:
        argv = [*E2E_COMMON, *flags, "--checkpoint", str(checkpoint), "--out",
                str(folder / fname)]
        log = io.StringIO()
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            result = end_to_end_sim.main(argv)
        secs = time.perf_counter() - t0
        print(log.getvalue(), end="", flush=True)
        launches = _counts(wrappers)
        per_call = 256 * (324 if "ldpc" in flags else 250 if "--coded" in flags else 512)
        bits = 3 * 8 * per_call
        vals = ([result["prediction_nmse"]] + list(result["se"].values())
                + [x for row in result["ber"].values() for x in row]
                + [x for row in result.get("bler", {}).values() for x in row])
        finite = len(vals) == 1 + 3 + 24 * (2 if "--coded" in flags else 1) and all(
            math.isfinite(x) for x in vals)
        written = (folder / fname).exists()
        print(f"e2e driver: cli.end_to_end_sim {' '.join(flags) or '(uncoded)'}: {secs:.1f} s, "
              f"{bits / secs:,.0f} Monte-Carlo bits/s ({bits:,} payload bits); launches "
              f"{_launch_report(launches, expected)}; prediction NMSE "
              f"{result['prediction_nmse']:.5f}; SE {result['se']}; finite {finite}, written "
              f"{written} | {card}", flush=True)
        if launches != expected:
            fail(f"cli.end_to_end_sim {flags} launched {launches}, not {expected}")
        if not (finite and written):
            fail(f"cli.end_to_end_sim {flags}: rows not finite or file missing")
        out[branch] = dict(argv=argv, seconds=secs, bits=bits, launches=launches, result=result)
    merged_path = folder / "e2e_branches.json"
    merged = collect_e2e.main(["--extra", *(f"{b}={folder / f}" for b, f, _ in E2E_RUNS),
                               "--out", str(merged_path)])
    if not (merged_path.exists() and all(merged[b] == out[b]["result"] for b, _, _ in E2E_RUNS)):
        fail("cli.collect_e2e did not merge the five runs")
    print(f"e2e collect: cli.collect_e2e merged {sorted(merged)} into {merged_path}", flush=True)
    return out


def attention_calls(cfg):
    """``(l_q, l_k, E)`` of each attention call of ``cfg``'s InformerStack
    (``models/encoder.py``: encoder i reads the last L // 2^i slots, a
    distilling conv between its layers; the decoder's self and cross calls)."""
    from channelestimationtransformer_torch.models.encoder import (
        distilled_length,
        encoder_stack_output_length,
    )

    e = cfg.d_model // cfg.n_heads
    calls = []
    for i, n_layers in enumerate(cfg.e_layers):
        length = cfg.seq_len // 2**i
        for j in range(n_layers):
            calls.append((length, length, e))
            if cfg.distil and j < n_layers - 1:
                length = distilled_length(length)
    l_dec = cfg.label_len + cfg.pred_len
    l_enc = encoder_stack_output_length(cfg.seq_len, cfg.e_layers, cfg.distil)
    return calls + [(l_dec, l_dec, e), (l_dec, l_enc, e)] * cfg.d_layers


def routed_calls(cfg, training):
    """Attention calls a forward sends to (bd, mha), by the routing of
    ``models/attention.py``: bd where it takes the shape; else, in eval, mha."""
    from channelestimationtransformer_torch.ops.cuda.bd_attention import MAX_E, MAX_LK, MAX_LQ
    from channelestimationtransformer_torch.ops.cuda.mha_attention import MAX_WIDTH

    calls = attention_calls(cfg)
    bd = sum(l_k <= MAX_LK and l_q <= MAX_LQ and e <= MAX_E for l_q, l_k, e in calls)
    mha = 0 if training else sum(e <= MAX_WIDTH for _, _, e in calls) - bd
    return bd, mha


def weight_only_call_dtypes(torch, cfg):
    """The dtype of each attention call (:func:`attention_calls`' order) of
    ``cfg``'s bf16 model under weight-only int8 serving: a served distil
    conv's BatchNorm runs on its f32 running statistics, so an encoder
    stack's calls after its first distil conv see f32, and so does its
    output; the decoder's first self call sees its bf16 embedding, its cross
    calls the encoder's output, and every later call the result of those."""
    dtypes, enc_out = [], torch.bfloat16
    for n_layers in cfg.e_layers:
        dtype = torch.bfloat16
        for j in range(n_layers):
            dtypes.append(dtype)
            if cfg.distil and j < n_layers - 1:
                dtype = torch.float32
        enc_out = torch.promote_types(enc_out, dtype)
    dec = torch.bfloat16
    for _ in range(cfg.d_layers):
        dtypes.append(dec)
        dec = torch.promote_types(dec, enc_out)
        dtypes.append(dec)
    return dtypes


def mha_routes(cfg, dtype, forwards=1):
    """Launches of each mha route that ``forwards`` eval forwards of
    ``cfg``'s model send (the calls of :func:`routed_calls` on mha, at
    ``dtype``, or at each call's dtype where ``dtype`` is a list; the
    model's q, k, v are fresh contiguous copies, so aligned)."""
    from channelestimationtransformer_torch.ops.cuda.bd_attention import MAX_E, MAX_LK, MAX_LQ
    from channelestimationtransformer_torch.ops.cuda.mha_attention import (
        MAX_WIDTH,
        ROUTES,
        mha_route,
    )

    calls = attention_calls(cfg)
    dtypes = dtype if isinstance(dtype, list) else [dtype] * len(calls)
    counts = dict.fromkeys(ROUTES, 0)
    for (l_q, l_k, e), dt in zip(calls, dtypes):
        if e <= MAX_WIDTH and not (l_k <= MAX_LK and l_q <= MAX_LQ and e <= MAX_E):
            counts[mha_route(dt, l_q, l_k, e, e, True)] += forwards
    return counts


def scale_kernel_shapes():
    """The attention calls of the scale demo's and the int8 A/B's sizes that
    ``SHAPES`` and ``XL_SHAPES`` leave out, each distinct (l_q, l_k, causal,
    E) once at the batch of the first size that makes it: ``(bd, mha)``
    lists of (label, l_q, l_k, causal, 0, b, h, e, d), split by the routing
    of :func:`routed_calls` (in training the calls bd does not take run the
    plain path). The decoder's self calls are causal."""
    from channelestimationtransformer_torch.cli import scale_demo
    from channelestimationtransformer_torch.ops.cuda.bd_attention import MAX_E, MAX_LK, MAX_LQ

    seen = {(l_q, l_k, causal, E) for _, l_q, l_k, causal, _ in SHAPES}
    seen |= {(l_q, l_k, causal, XL_E) for _, l_q, l_k, causal, _ in XL_SHAPES}
    bd, mha = [], []
    for name, d_model, d_ff, seq_len, batch in scale_demo.SIZES:
        cfg = scale_demo.size_config(d_model, d_ff, seq_len, "float32")
        calls = attention_calls(cfg)
        n_enc = len(calls) - 2 * cfg.d_layers
        for i, (l_q, l_k, e) in enumerate(calls):
            causal = i >= n_enc and (i - n_enc) % 2 == 0
            if (l_q, l_k, causal, e) in seen:
                continue
            seen.add((l_q, l_k, causal, e))
            label = f"{name} E{e} {l_q}x{l_k}{' causal' if causal else ''}"
            on_bd = l_k <= MAX_LK and l_q <= MAX_LQ and e <= MAX_E
            (bd if on_bd else mha).append((label, l_q, l_k, causal, 0, batch, cfg.n_heads, e, e))
    return bd, mha


SCALE_STEPS, SCALE_CHUNKS = 2, 1


def phase_scale_demo(torch, wrappers, card):
    """``cli.scale_demo`` at its six sizes in bf16 (``SCALE_STEPS`` steps a
    chunk, one warm and ``SCALE_CHUNKS`` timed chunks), one size a call: the
    parameters against JAX's column (``experiments/artifacts/scale_demo.json``),
    bd forward and backward launches against the routing's counts (the FLOP
    count's step runs the plain path), FLOPs and the share of peak."""
    from channelestimationtransformer_torch.cli import scale_demo

    jax_rows = {r["config"]: r for r in json.loads(
        pathlib.Path("experiments/artifacts/scale_demo.json").read_text())}
    folder = OUT / "scale_demo"
    rows = {}
    for name, d_model, d_ff, seq_len, batch in scale_demo.SIZES:
        bd, _ = routed_calls(scale_demo.size_config(d_model, d_ff, seq_len, "bfloat16"), True)
        steps = SCALE_STEPS * (1 + SCALE_CHUNKS)
        expected = {key: 0 for key in _counts(wrappers)}
        expected.update(bd_fwd=bd * steps, bd_bwd=bd * steps)
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            (row,) = scale_demo.main(["--sizes", name, "--steps", str(SCALE_STEPS),
                                      "--chunks", str(SCALE_CHUNKS), "--out",
                                      str(folder / f"scale_demo_{name}.json")])
        secs = time.perf_counter() - t0
        launches = _counts(wrappers)
        print(f"scale demo {name} (d_model {d_model}, d_ff {d_ff}, seq_len {seq_len}, batch "
              f"{batch}, bf16): {secs:.1f} s; params {row['params']:,} (JAX "
              f"{jax_rows[name]['params']:,}); launches {_launch_report(launches, expected)} "
              f"({bd} of 13 calls on bd a step); {row['ms_per_step']} ms a step, "
              f"{row['samples_per_s']} samples/s, {row['gflops_per_step']} GFLOP a step "
              f"(FlopCounterMode, plain path; JAX's XLA count "
              f"{jax_rows[name]['gflops_per_step']}), {row['achieved_tflops']} TFLOP/s, "
              f"{row['mxu_fraction']:.4f} of {row['peak_tflops']} | {card}", flush=True)
        if row["params"] != jax_rows[name]["params"]:
            fail(f"scale demo {name}: {row['params']} parameters, JAX has "
                 f"{jax_rows[name]['params']}")
        if launches != expected:
            fail(f"scale demo {name} launched {launches}, not {expected}")
        if not (row["gflops_per_step"] > 0 and math.isfinite(row["ms_per_step"])):
            fail(f"scale demo {name}: no FLOPs or no time")
        rows[name] = dict(row=row, seconds=secs, launches=launches)
    return rows


INT8_AB_SCAN, INT8_AB_REPS = 2, 2


def phase_int8_scale_ab(torch, wrappers, gemms, card):
    """``cli.int8_scale_ab`` at its four sizes (``--scan`` and ``--reps``
    cut), one size a call: bd and mha launches against the routing's eval
    counts for all four variants, mha's by route (the f32 and W8A8 variants'
    attention in f32, the bf16 one's in bf16, the weight-only one's at
    :func:`weight_only_call_dtypes`), int8 GEMMs
    (W8A8) and bf16 -> f32 GEMMs (weight-only) one a served layer a
    forward, finite timings."""
    from channelestimationtransformer_torch.cli import int8_scale_ab
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import InformerStack
    from channelestimationtransformer_torch.ops.quant.serving import build_int8_table

    folder = OUT / "int8_scale_ab"
    forwards = (2 + INT8_AB_REPS) * INT8_AB_SCAN  # two warm-ups, then the timed reps
    rows = {}
    for name, d_model, d_ff, seq_len, batch in int8_scale_ab.SIZES:
        cfg = InformerConfig(d_model=d_model, d_ff=d_ff, seq_len=seq_len)
        bd, mha = routed_calls(cfg, False)
        with torch.device("meta"):
            served = len(build_int8_table(InformerStack(cfg)))
        expected = {key: 0 for key in _counts(wrappers)}
        # conv kernels: the float32 variant's 7 convs and the W8A8 variant's
        # 2 embeddings (its distil convs int8); the bf16-based ones take cuDNN
        expected.update(bd_fwd=4 * forwards * bd, mha=4 * forwards * mha,
                        **_conv_launches(forwards, convs=7 + 2))
        variants = (mha_routes(cfg, torch.float32, 2 * forwards),
                    mha_routes(cfg, torch.bfloat16, forwards),
                    mha_routes(cfg, weight_only_call_dtypes(torch, cfg), forwards))
        want_routes = {r: sum(v[r] for v in variants) for r in variants[0]}
        want_gemm = dict(int8=forwards * served, bf16_f32=forwards * served)
        _zero_counts(wrappers)
        _zero_counts(gemms)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            (row,) = int8_scale_ab.main(["--sizes", name, "--scan", str(INT8_AB_SCAN),
                                         "--reps", str(INT8_AB_REPS), "--out",
                                         str(folder / f"int8_scale_ab_{name}.json")])
        secs = time.perf_counter() - t0
        launches, gemm = _counts(wrappers), _counts(gemms)
        routes = dict(wrappers["mha"].launches_by_route)
        ms = {v: row[f"ms_{v}"] for v in ("float32", "bfloat16", "int8", "int8_wo")}
        print(f"int8 A/B {name} (d_model {d_model}, seq_len {seq_len}, batch {batch}): "
              f"{secs:.1f} s; launches {_launch_report(launches, expected)}; mha by route "
              f"{routes} (expected {want_routes}); GEMMs {gemm} "
              f"(expected {want_gemm}, {served} served layers); ms a forward {ms}; "
              f"int8 {row['int8_speedup_vs_f32']}x f32, weight-only "
              f"{row['int8_wo_speedup_vs_bf16']}x bf16 | {card}", flush=True)
        if launches != expected or gemm != want_gemm or routes != want_routes:
            fail(f"int8 A/B {name} launched {launches}, {gemm}, mha by route {routes}; "
                 f"expected {expected}, {want_gemm}, {want_routes}")
        if not all(math.isfinite(t) and t > 0 for t in ms.values()):
            fail(f"int8 A/B {name}: a timing is not finite")
        rows[name] = dict(row=row, seconds=secs, launches=launches, gemm_launches=gemm,
                          mha_launches_by_route=routes)
    return rows


# The analysis phase: utils/ and the analysis drivers on the card. The trace
# holds one flagship eval chunk (13 bd forward launches a batch); the timing
# sweep is cut to two axes (every point: 3 eager warm-up forwards and 20 in a
# CUDA graph, 13 bd forward launches each); eval_parity_ci evaluates the cli
# phase's checkpoint on 8 batches (13 bd forward launches each).
TIMING_ARGS = ["--params", "seq_len", "batch", "--reps", "3"]
TIMING_POINTS, TIMING_FORWARDS = 4 + 3, 3 + 20
PARITY_CI_BATCHES = 8
PARITY_CI_RTOL = 1e-4  # kernel path vs plain path, the mean of the per-batch values
AR_CARD_RTOL = 1e-4  # card vs CPU: complex64 products summed in other orders
# experiments/artifacts/ar_oracle.json: order 30, 14-symbol slots, 30 km/h (the
# defaults), 256 windows, these SNRs.
AR_SNRS = ["12", "14", "16", "18", "20", "21"]
AR_ARGS = ["--slot-symbols", "14", "--order", "30", "--snr", *AR_SNRS]
NATIVE_N = 1 << 20


def timing_kernel_shapes():
    """The attention calls of ``cli.timing_analysis``'s full sweep (E 8,
    16 and 32; other lengths) that ``SHAPES`` and the scale demo's leave
    out, each distinct (l_q, l_k, causal, E) once at batch 256, all on the bd
    forward (every sweep point takes it): (label, l_q, l_k, causal, 0, b, h,
    e, d)."""
    from channelestimationtransformer_torch.cli import timing_analysis

    seen = {(l_q, l_k, causal, E) for _, l_q, l_k, causal, _ in SHAPES}
    seen |= {(l_q, l_k, causal, e) for _, l_q, l_k, causal, _, _, _, e, _ in
             scale_kernel_shapes()[0]}
    out = []
    for key, cfg, batch in timing_analysis.sweep_configs(list(timing_analysis.DEFAULT_SWEEP),
                                                         256):
        calls = attention_calls(cfg)
        n_enc = len(calls) - 2 * cfg.d_layers
        for i, (l_q, l_k, e) in enumerate(calls):
            causal = i >= n_enc and (i - n_enc) % 2 == 0
            if (l_q, l_k, causal, e) in seen:
                continue
            seen.add((l_q, l_k, causal, e))
            out.append((f"{key} E{e} {l_q}x{l_k}{' causal' if causal else ''}", l_q, l_k,
                        causal, 0, batch, cfg.n_heads, e, e))
    return out


def _driver(wrappers, fn, argv):
    """``fn(argv)`` in this process with its stdout captured: (result,
    launches, seconds, log text)."""
    log = io.StringIO()
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = fn(argv)
    return result, _counts(wrappers), time.perf_counter() - t0, log.getvalue()


def _native_vs_kernels(torch, np, quant, draw_seed, cbm):
    """``native`` (built here with g++) against the quant kernels and
    ``data/packing.py`` on the same inputs: nearest fixed point and nearest
    codeword bit for bit, window packing bit for bit, stochastic rounding by
    its mean (its stream differs: ``std::mt19937_64`` against Philox)."""
    from channelestimationtransformer_torch import native
    from channelestimationtransformer_torch.data.packing import complex_to_real

    lib, log = native.build()
    print(f"native: {lib.name} built with {' '.join(native.CXX_FLAGS)}"
          f"{' (' + log.strip()[:200] + ')' if log.strip() else ''}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = _fixed_input(torch, NATIVE_N, gen)
    x_host = x.cpu().numpy()
    fixed = 0
    for wl, fl in FIXED_FORMATS:
        for symmetric in (False, True):
            for clamp in (True, False):
                got = native.fixed_point_quantize(x_host, wl, fl, clamp=clamp,
                                                  symmetric=symmetric)
                want = quant.fused_fixed_point_quantize(x, wl, fl, clamp=clamp,
                                                        symmetric=symmetric).cpu().numpy()
                if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
                    fail(f"native fixed point != fixed_point_quantize.cu at wl {wl} fl {fl} "
                         f"symmetric {symmetric} clamp {clamp}")
                fixed += 1
    codeword = 0
    for label, cb in _codebooks(cbm):
        xc = _codeword_input(torch, np, NATIVE_N, cb, gen)
        got = native.nearest_codeword(xc.cpu().numpy(), cb)
        want = quant.fused_nearest_codeword(
            xc, torch.tensor(cb, dtype=torch.float32, device="cuda")).cpu().numpy()
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            fail(f"native nearest codeword != nearest_codeword.cu with {label}")
        codeword += 1
    h = torch.randn(256, 100, 2, 4, dtype=torch.complex64, generator=gen, device="cuda")
    starts = torch.randint(0, 6, (256,), generator=gen, device="cuda")
    packed = complex_to_real(h)
    pos = (starts[:, None] + torch.arange(95, device="cuda"))[:, :, None].expand(-1, -1, 16)
    want = torch.gather(packed, 1, pos).cpu().numpy()
    got = native.pack_windows(h.cpu().numpy(), starts.cpu().numpy(), 95)
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        fail("native pack_windows != data/packing.py's windows")
    u = torch.rand(NATIVE_N, generator=gen, device="cuda") * 2 - 1
    wl, fl = PTQ_WL, PTQ_FL
    mean_native = float(native.fixed_point_quantize(u.cpu().numpy(), wl, fl,
                                                    rounding="stochastic", seed=3)
                        .astype(np.float64).mean())
    mean_kernel = quant.fused_fixed_point_quantize(
        u, wl, fl, stochastic=True, seed=draw_seed(torch.Generator(device="cuda").manual_seed(3),
                                                   "cuda")).double().mean().item()
    # Each rounding errs by at most one grid step 2^-fl; the means of two
    # independent unbiased roundings differ by 4 sigma at most.
    limit = 4 * math.sqrt(2) * 2.0 ** -fl / 2 / math.sqrt(NATIVE_N)
    diff = abs(mean_native - mean_kernel)
    print(f"native vs kernels ({NATIVE_N:,} elements): fixed point nearest {fixed} settings "
          f"bit for bit with fixed_point_quantize.cu, nearest codeword {codeword} codebooks "
          f"bit for bit with nearest_codeword.cu, pack_windows (256 x 95 of 100 slots, 2 x 4) "
          f"bit for bit with data/packing.py; stochastic wl {wl} fl {fl}: mean {mean_native:.6e} "
          f"vs the kernel's {mean_kernel:.6e}, |diff| {diff:.3e} (limit {limit:.3e})", flush=True)
    if diff > limit:
        fail("native stochastic rounding's mean is off the kernel's")
    return dict(fixed_settings=fixed, codebooks=codeword, stochastic_mean_native=mean_native,
                stochastic_mean_kernel=mean_kernel, stochastic_limit=limit)


def phase_analysis(torch, wrappers, card, checkpoint_dir, cli_name, cli_log):
    """``utils/`` and the analysis drivers on the card: a ``trace`` of one
    flagship eval chunk holding its 104 bd forward kernels;
    ``time_fn_amortized`` of one flagship forward beside ``time_ms``;
    ``device_memory_stats`` against ``max_memory_allocated``;
    ``model_complexity`` of the five models equal to the CPU's and launching
    no kernel; ``native`` against the quant kernels and the packing;
    ``ar_oracle_nmse`` card vs CPU and ``cli.ar_oracle`` at the committed
    artifact's settings; ``cli.timing_analysis`` on two axes (monotonic);
    ``cli.eval_parity_ci`` from the cli phase's checkpoint, kernel path vs
    plain path; ``cli.complexity_report`` and ``cli.collect_results``; and
    the host-only ``parse_logs`` over the cli phase's log and
    ``MetricsWriter`` (its JSONL branch where ``tensorboard`` is missing)."""
    import numpy as np

    from channelestimationtransformer_torch.channel.cdl import CDLModel
    from channelestimationtransformer_torch.channel.dataset import make_window_dataset
    from channelestimationtransformer_torch.cli import (
        ar_oracle,
        collect_results,
        complexity_report,
        eval_parity_ci,
        timing_analysis,
    )
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.core.runtime import stream_generator
    from channelestimationtransformer_torch.data.windows import sample_windows
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import quant
    from channelestimationtransformer_torch.ops.quant import codebooks
    from channelestimationtransformer_torch.train.trainer import eval_chunk
    from channelestimationtransformer_torch.utils import profiling
    from channelestimationtransformer_torch.utils.complexity import model_complexity
    from channelestimationtransformer_torch.utils.parse_logs import parse_log_text
    from channelestimationtransformer_torch.utils.tensorboard import MetricsWriter

    t_phase = time.perf_counter()
    folder = OUT / "analysis"
    folder.mkdir(exist_ok=True)
    out = {}
    none = {key: 0 for key in _counts(wrappers)}

    # The bd shapes of the full timing sweep that no phase holds yet.
    shapes = timing_kernel_shapes()
    out["timing_kernel_rows"] = phase_kernel(torch, None, ops.bd_attention,
                                             ops.bd_attention_reference, shapes,
                                             prefix="timing kernel", seed=5, timed=False)
    print(f"timing kernels: {len(shapes)} bd shapes of cli.timing_analysis's sweep beyond "
          f"the phases above, float32 and bfloat16, each against its plain version", flush=True)

    # trace: one flagship eval chunk on the kernel path.
    cfg = InformerConfig(use_pallas=True)
    model = build_informer(cfg, device="cuda", seed=0)
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096)

    def chunk():
        return eval_chunk(model, ds, num_batches=8, batch_size=256, label_len=cfg.label_len,
                          generator=torch.Generator(device="cuda").manual_seed(1))
    chunk()
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    with profiling.trace(str(folder / "trace")) as prof:
        chunk()
        torch.cuda.synchronize()
    launches = _counts(wrappers)
    events = json.loads(pathlib.Path(prof.trace_path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    bd = [e for e in kernels if "bd_attention_fwd_kernel" in e.get("name", "")]
    expected = dict(none, bd_fwd=13 * 8) | _conv_launches(forwards=8)
    ok = len(bd) == 13 * 8 and launches == expected
    print(f"trace: utils.profiling.trace over one flagship eval chunk (8 x 256, kernels on): "
          f"{prof.trace_path} ({pathlib.Path(prof.trace_path).stat().st_size / 1e6:.1f} MB), "
          f"{len(kernels)} device kernels, {len(bd)} named bd_attention_fwd_kernel (expected "
          f"104; e.g. {bd[0]['name'][:60] if bd else None!r}); launches "
          f"{_launch_report(launches, expected)} {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        calls = [e for e in events if e.get("cat") == "cuda_runtime"
                 and "Launch" in e.get("name", "")]
        names = collections.Counter(e.get("name", "")[:60] for e in kernels)
        print(f"trace: {len(calls)} launch calls on the host for {len(kernels)} device kernels; "
              f"kernels by name {names.most_common()}", flush=True)
        fail("the trace does not hold the bd forward kernel 104 times")
    out["trace"] = dict(path=prof.trace_path, device_kernels=len(kernels), bd_fwd=len(bd),
                        launches=launches)
    pathlib.Path(prof.trace_path).unlink()  # tens of MB: too large to bring back

    # time_fn_amortized against this script's time_ms, one flagship forward.
    x_enc = torch.randn(256, cfg.seq_len, cfg.enc_in, device="cuda")
    x_dec = torch.randn(256, cfg.dec_len, cfg.dec_in, device="cuda")

    @torch.no_grad()
    def fwd(a, b):
        return model(a, b)
    amortized, amortized_std = profiling.time_fn_amortized(fwd, x_enc, x_dec, inner=20,
                                                           warmup=3, reps=21)
    graph_ms = time_ms(torch, lambda: fwd(x_enc, x_dec))
    host_ms, _ = profiling.time_fn(fwd, x_enc, x_dec, warmup=3, reps=21)
    print(f"time_fn_amortized: one flagship eval forward (256 windows, kernels on) "
          f"{amortized:.4f} +- {amortized_std:.4f} ms; chip_smoke time_ms {graph_ms:.4f} ms "
          f"(both CUDA-graph replay, 20 a graph); time_fn (eager, host clock) {host_ms:.4f} ms "
          f"| {card}", flush=True)
    out["forward_ms"] = dict(time_fn_amortized=amortized, std=amortized_std, time_ms=graph_ms,
                             time_fn=host_ms)

    # device_memory_stats against the allocator's own counters.
    stats = profiling.device_memory_stats()
    peak, live = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    ok = (stats["peak_bytes_in_use"] == peak and stats["bytes_in_use"] == live
          and stats["bytes_limit"] == total)
    print(f"device_memory_stats: {stats}; max_memory_allocated {peak:,}, memory_allocated "
          f"{live:,}, mem_get_info total {total:,} {'equal' if ok else 'DIFFERENT'}", flush=True)
    if not ok:
        fail("device_memory_stats disagrees with torch.cuda's counters")
    out["memory"] = stats
    del model, ds

    # complexity: cli.complexity_report on the card, its count against the CPU's.
    report, launches, secs, _ = _driver(wrappers, complexity_report.main,
                                        ["--out", str(folder / "complexity.json")])
    cpu_report = complexity_report.report(1, torch.device("cpu"))
    kernel_model = build_informer(InformerConfig(use_pallas=True), device="cuda", seed=0)
    _zero_counts(wrappers)
    kernel_twin = model_complexity(kernel_model, torch.zeros(1, 90, 16, device="cuda"),
                                   torch.zeros(1, 15, 16, device="cuda"))
    twin_launches = _counts(wrappers)
    ok = (report == cpu_report and launches == none and twin_launches == none
          and kernel_twin == report["informer_stack"])
    for name, row in report.items():
        print(f"complexity {name}: params {row['params']:,}, MACs/sample "
              f"{row['macs_per_sample']:,.0f} (card), {cpu_report[name]['macs_per_sample']:,.0f} "
              f"(CPU)", flush=True)
    print(f"driver phase: cli.complexity_report: {secs:.1f} s; card equal to CPU "
          f"{report == cpu_report}; the use_pallas flagship counted on its plain twin equal "
          f"{kernel_twin == report['informer_stack']}; launches {_launch_report(launches, none)}, "
          f"through the twin {_launch_report(twin_launches, none)} {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        fail("model_complexity on the card differs from the CPU's or launched a kernel")
    out["complexity"] = dict(report=report, seconds=secs)
    del kernel_model

    out["native"] = _native_vs_kernels(torch, np, quant, ops.draw_seed, codebooks)

    # ar_oracle: card vs CPU on the same windows, then cli.ar_oracle at the
    # committed artifact's settings.
    oracle_model = CDLModel(sampling_frequency=120e3 / 14, ue_speed_ms=30 / 3.6)
    ds = make_window_dataset(1234, model=oracle_model, num_samples=1024, num_slots=100,
                             snr_db=12.0, device="cuda")
    _, _, hist, future = sample_windows(ds, 256, generator=stream_generator("cuda", 5678))
    card_nmse, card_split = ar_oracle.ar_oracle_nmse(hist, future, 30)
    cpu_nmse, cpu_split = ar_oracle.ar_oracle_nmse(hist.cpu(), future.cpu(), 30)
    rel = max(abs(a - b) / abs(b) for a, b in zip([card_nmse] + card_split,
                                                  [cpu_nmse] + cpu_split))
    print(f"ar_oracle_nmse card vs CPU (256 windows, order 30, SNR 12, 14-symbol slots; "
          f"{256 * 8:,} ridge solves at once): nmse {card_nmse:.6f} / {cpu_nmse:.6f}, worst "
          f"relative |diff| {rel:.3e} (limit {AR_CARD_RTOL}) "
          f"{'ok' if rel <= AR_CARD_RTOL else 'FAILED'}", flush=True)
    if not rel <= AR_CARD_RTOL:
        fail("ar_oracle_nmse on the card differs from the CPU")
    del ds
    oracle, launches, secs, log = _driver(wrappers, ar_oracle.main,
                                          [*AR_ARGS, "--out", str(folder / "ar_oracle.json")])
    committed = json.loads(pathlib.Path("experiments/artifacts/ar_oracle.json").read_text())
    deltas = {snr: oracle["snr"][f"{float(snr)}"]["nmse_db"]
              - committed["snr"][f"{float(snr)}"]["nmse_db"] for snr in AR_SNRS}
    print(log, end="", flush=True)
    print(f"driver phase: cli.ar_oracle {' '.join(AR_ARGS)}: {secs:.1f} s; launches "
          f"{_launch_report(launches, none)}; dB against the committed "
          f"experiments/artifacts/ar_oracle.json (JAX's channel draws; band +-1 dB, not held): "
          + ", ".join(f"SNR {s} {d:+.2f}" for s, d in deltas.items()) + f" | {card}", flush=True)
    if launches != none or not all(math.isfinite(d) for d in deltas.values()):
        fail("cli.ar_oracle launched a kernel or gave a non-finite NMSE")
    out["ar_oracle"] = dict(card_vs_cpu_rel=rel, result=oracle, delta_db=deltas, seconds=secs)

    # timing_analysis on two axes.
    results, launches, secs, log = _driver(
        wrappers, timing_analysis.main,
        [*TIMING_ARGS, "--out", str(folder / "runtime.json")])
    print(log, end="", flush=True)
    expected = (dict(none, bd_fwd=13 * TIMING_FORWARDS * TIMING_POINTS)
                | _conv_launches(forwards=TIMING_FORWARDS * TIMING_POINTS))
    ok = results["_monotonic"] is True and launches == expected
    print(f"driver phase: cli.timing_analysis {' '.join(TIMING_ARGS)}: {secs:.1f} s; monotonic: "
          f"{str(results['_monotonic']).lower()}; launches {_launch_report(launches, expected)} "
          f"| {card}", flush=True)
    if not ok:
        fail("cli.timing_analysis is not monotonic or launched the wrong kernels")
    out["timing_analysis"] = dict(results=results, launches=launches, seconds=secs)

    # eval_parity_ci from the cli phase's checkpoint: kernel path (the
    # driver), then the plain path on the same batches.
    parity_path = folder / "parity.json"
    parity_path.write_text(json.dumps({"sweeps": {"snr": {"rows": {
        "20": {"run": cli_name, "ref": collect_results.REFERENCE["snr"][20]}}}}}))
    ci_argv = ["--parity", str(parity_path), "--weights", str(checkpoint_dir), "--batches",
               str(PARITY_CI_BATCHES), "--out", str(folder / "parity_ci.json")]
    ci, launches, secs, log = _driver(wrappers, eval_parity_ci.main, ci_argv)
    print(log, end="", flush=True)
    row = ci["rows"]["snr:20"]
    plain = eval_parity_ci.evaluate_row(cli_name, "snr", 20.0, weights=str(checkpoint_dir),
                                        batches=PARITY_CI_BATCHES, val_samples=2048,
                                        device=torch.device("cuda"), use_pallas=False,
                                        ds_cache={})
    rel = abs(row["mean"] - plain["mean"]) / plain["mean"]
    expected = dict(none, bd_fwd=13 * PARITY_CI_BATCHES) | _conv_launches(PARITY_CI_BATCHES)
    ok = launches == expected and rel <= PARITY_CI_RTOL and row["n"] == PARITY_CI_BATCHES
    print(f"driver phase: cli.eval_parity_ci --batches {PARITY_CI_BATCHES} (the cli phase's "
          f"checkpoint, epoch {row['checkpoint_epoch']}): {secs:.1f} s; mean {row['mean']:.6f}, "
          f"CI {[round(v, 6) for v in row['ci95']]}, delta {row['delta_db']:+.2f} dB against "
          f"the reference's SNR-20 row; plain path mean {plain['mean']:.6f}, relative |diff| "
          f"{rel:.3e} (limit {PARITY_CI_RTOL}); launches {_launch_report(launches, expected)} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail("cli.eval_parity_ci: wrong launches, or the kernel path's mean is off the plain "
             "path's")
    out["eval_parity_ci"] = dict(row=row, plain_mean=plain["mean"], rel=rel, launches=launches,
                                 seconds=secs)

    # collect_results over the committed results and the cli phase's.
    results_dir = folder / "results"
    results_dir.mkdir(exist_ok=True)
    for path in list(pathlib.Path("experiments/artifacts").glob("result_*.json")) + [
            checkpoint_dir / f"result_{cli_name}.json"]:
        (results_dir / path.name).write_bytes(path.read_bytes())
    parity, launches, secs, _ = _driver(wrappers, collect_results.main, [str(results_dir)])
    rows = sum(len(b["rows"]) for b in parity["sweeps"].values())
    written = all((results_dir / n).exists() for n in ("snr_table.json", "parity.json",
                                                        "PARITY_RESULTS.md"))
    print(f"driver phase: cli.collect_results ({len(list(results_dir.glob('result_*.json')))} "
          f"result files): {secs:.2f} s; {rows} parity rows over {len(parity['sweeps'])} sweeps, "
          f"files written {written}; launches {_launch_report(launches, none)}", flush=True)
    if not (written and rows and launches == none):
        fail("cli.collect_results wrote no table")
    out["collect_results"] = dict(rows=rows, seconds=secs)

    # The host-only utilities: the cli phase's log parsed, the reference's
    # scalars written and read back.
    parsed = parse_log_text(cli_log)[cli_name]
    writer = MetricsWriter(str(folder / "runs"))
    branch = "tensorboard" if writer._tb is not None else "jsonl"
    for epoch, (valid, split) in enumerate(zip(parsed["valid_loss"], parsed["split"])):
        writer.log_epoch(epoch, 1.0, valid, split)
    writer.close()
    tags = (sorted(json.loads(line)["tag"] for line in
                   (folder / "runs" / "events.jsonl").read_text().splitlines())
            if branch == "jsonl" else None)
    ok = (parsed["epochs"] == list(range(CLI_EPOCHS)) and len(parsed["valid_loss"]) == CLI_EPOCHS
          and (tags is None or len(tags) == 7 * CLI_EPOCHS))
    print(f"parse_logs: the cli phase's log: epochs {parsed['epochs']}, valid loss "
          f"{parsed['valid_loss']}, {len(parsed['ms_per_batch'])} batch lines; MetricsWriter "
          f"({branch} branch): {len(tags) if tags else 'tensorboard'} scalars "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail("parse_logs or MetricsWriter failed on the cli phase's log")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"analysis phase: {out['seconds']:.1f} s", flush=True)
    return out


# The drivers phase: the last eight experiment drivers, cut short. Keys of
# each one's JSON as the JAX package's committed artifact (less the
# slot-geometry prong's, which needs the reference's pickle); perf_study and
# interleaved_ab add "route" / "runs_as" to their rows.
DRIVER_ARGS = {
    "calibrate_channel": ["--speeds", "5,6", "--n", "512"],
    "calibrate_fast": ["--speeds", "10,30", "--slot-symbols", "25", "--n", "512"],
    "prob_crossover": ["--shapes", "128:192,2048:12"],
    "prob_profile": [],
    "step_profile": ["--chunks", "1", "--steps", "2"],
    "perf_study": ["--reps", "10", "--steps", "2"],
    "interleaved_ab": ["--steps", "2", "--rounds", "2"],
}
PICKLE_KEYS = {"pickle_lag_curve", "pickle_hankel_rank", "ours_30kmh_lag_curve",
               "ours_30kmh_hankel_rank"}
ARTIFACTS = pathlib.Path("experiments/artifacts")
PALLAS_AB_RUN = ("result_ei_16_di_16_co_16_sl_90_ll_10_pl_5_f_5_dm_128_nh_8_el_[4, 3]_dl_3_df_64"
                 "_do_0.05_at_full_em_fixed_ac_gelu_21_cal_v5_bf16_rbg_pallas_r4ab.json")


def _row_keys(rows):
    return [sorted(set(r) - {"route", "runs_as"}) for r in rows]


def phase_drivers(torch, wrappers, card):
    """The calibration and profiling drivers in this process, cut short
    (``DRIVER_ARGS``), outputs under ``chiprun_out/drivers/``: each one's
    JSON keys against its committed JAX artifact, no row with an error,
    the calibration fit inside its speed grid, perf_study's kernels launched
    (bd, mha, fixed point) and each row's route; then ``cli.pallas_ab`` on
    copies of the committed r4ab result and ``parity.json``, byte for byte
    the committed ``pallas_ab.json``."""
    from channelestimationtransformer_torch.cli import (
        calibrate_channel,
        calibrate_fast,
        interleaved_ab,
        pallas_ab,
        perf_study,
        prob_crossover,
        prob_profile,
        step_profile,
    )

    t_phase = time.perf_counter()
    folder = OUT / "drivers"
    folder.mkdir(exist_ok=True)
    modules = dict(calibrate_channel=calibrate_channel, calibrate_fast=calibrate_fast,
                   prob_crossover=prob_crossover, prob_profile=prob_profile,
                   step_profile=step_profile, perf_study=perf_study,
                   interleaved_ab=interleaved_ab)
    artifacts = dict(calibrate_channel="calibration.json", calibrate_fast="calibration_fast.json",
                     prob_crossover="prob_crossover.json", prob_profile="prob_profile.json",
                     step_profile="step_profile.json", perf_study="perf_study.json",
                     interleaved_ab="interleaved_ab_r5.json")
    runs = {}
    for name, module in modules.items():
        path = folder / f"{name}.json"
        _, launches, secs, log = _driver(wrappers, module.main,
                                         DRIVER_ARGS[name] + ["--out", str(path)])
        (folder / f"{name}.log").write_text(log)
        got = json.loads(path.read_text())
        want = json.loads((ARTIFACTS / artifacts[name]).read_text())
        problems = []
        if name == "calibrate_channel":
            keys_ok = set(got) == set(want) - PICKLE_KEYS
            grid = [float(v) for v in DRIVER_ARGS[name][1].split(",")]
            if got["fitted_speed_kmh"] not in grid:
                problems.append(f"fitted {got['fitted_speed_kmh']} km/h outside {grid}")
            note = (f"fitted {got['fitted_speed_kmh']} km/h, rms "
                    f"{got['fitted_rms_delta_db']} dB (grid {grid})")
        elif name == "perf_study":
            keys_ok = set(got) == set(want) and all(
                {tuple(k_) for k_ in _row_keys(got[k])} <= {tuple(k_) for k_ in
                                                             _row_keys(want[k])}
                for k in want)
            routes = [r.get("route") for rows in got.values() for r in rows]
            if any(r is None for r in routes):
                problems.append("a row without its route")
            for key in ("bd_fwd", "bd_bwd", "mha", "fixed"):
                if not launches[key]:
                    problems.append(f"no {COUNT_LABELS[key]} launch")
            note = ", ".join(f"{k} {len(v)} rows" for k, v in got.items())
        elif name == "interleaved_ab":
            keys_ok = {tuple(k) for k in _row_keys(got)} == {tuple(k) for k in _row_keys(want)}
            note = ", ".join(f"{r['variant']} {r['median_ms_per_batch']} ms" for r in got)
        elif name == "prob_crossover":
            keys_ok = set(got) == set(want) and all(set(r) == set(want["rows"][0])
                                                    for r in got["rows"])
            note = ", ".join(f"L {r['l']}: dense {r['ms_dense_select']} ms, gather "
                             f"{r['ms_key_gather']} ms" for r in got["rows"])
        elif name == "step_profile":
            keys_ok = set(got) == set(want) and list(got["rows"]) == list(want["rows"])
            note = f"canonical {got['rows']['canonical_bf16_bd_rbg']} a step"
        else:
            keys_ok = (set(got) == set(want) if name != "prob_profile"
                       else list(got) == list(want))
            note = f"{len(got)} keys"
        if not keys_ok:
            problems.append("JSON keys differ from the committed artifact's")
        if "error" in json.dumps(got):
            problems.append("a row with an error")
        runs[name] = dict(seconds=secs, launches=launches, problems=problems)
        print(f"driver phase: cli.{name} {' '.join(DRIVER_ARGS[name])}: {secs:.1f} s; {note}; "
              f"keys as {artifacts[name]} {keys_ok}; launches "
              f"{', '.join(f'{COUNT_LABELS[k]} {v}' for k, v in launches.items())} "
              f"{'ok' if not problems else 'FAILED: ' + '; '.join(problems)}", flush=True)
        if problems:
            fail(f"cli.{name}: {'; '.join(problems)}")
    ab = folder / "pallas_ab"
    ab.mkdir(exist_ok=True)
    for src in (PALLAS_AB_RUN, "parity.json"):
        shutil.copy(ARTIFACTS / src, ab / src)
    _, launches, secs, _ = _driver(wrappers, pallas_ab.main, [str(ab)])
    same = (ab / "pallas_ab.json").read_bytes() == (ARTIFACTS / "pallas_ab.json").read_bytes()
    print(f"driver phase: cli.pallas_ab on copies of the r4ab result and parity.json: equal to "
          f"experiments/artifacts/pallas_ab.json byte for byte {same} {'ok' if same else 'FAILED'}",
          flush=True)
    if not same:
        fail("cli.pallas_ab does not reproduce the committed pallas_ab.json")
    runs["pallas_ab"] = dict(seconds=secs, launches=launches, equal=same)
    runs["seconds"] = time.perf_counter() - t_phase
    print(f"drivers phase: {runs['seconds']:.1f} s | {card}", flush=True)
    return runs


# The parallel phase: each group of ranks is a subprocess of this script
# (``--parallel-rank``), joined under PARALLEL_TIMEOUT seconds.
PARALLEL_TIMEOUT = 300
PARALLEL_ROUNDS = 6  # chunks (or batches) of each path in turns; the first is dropped
# The ring's model: the xl widths (E 128) with the distilling convs off.
RING_CFG = dict(d_model=1024, d_ff=4096, seq_len=256, distil=False)
RING_BATCH = 64


def phase_parallel(torch, card):
    """NCCL at world 1 always, and across 2 or 4 ranks (4 where the machine
    has 4 cards; the ring's lengths 256 and 128 take no 3) where it has two
    or more: each group is :func:`parallel_rank` in subprocesses of this
    script, killed and failed past ``PARALLEL_TIMEOUT``."""
    from channelestimationtransformer_torch.parallel.launch import run_local

    cards = torch.cuda.device_count()
    worlds = [1] + ([4 if cards >= 4 else 2] if cards >= 2 else [])
    torch.cuda.empty_cache()  # the ranks share the card with this process
    folder = OUT / "parallel"
    folder.mkdir(exist_ok=True)
    runs = {}
    for world in worlds:
        path = folder / f"world_{world}.json"
        t0 = time.perf_counter()
        try:
            outs = run_local([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--parallel-rank", str(path)], world, timeout=PARALLEL_TIMEOUT)
        except RuntimeError as e:
            fail(f"parallel phase, {world} rank(s): {e}")
        print(outs[0], end="", flush=True)
        runs[world] = dict(json.loads(path.read_text()), seconds=time.perf_counter() - t0)
    multi = (f"and across {worlds[1]} ranks" if worlds[1:]
             else "and no multi-rank run (fewer than 2 cards)")
    secs = ", ".join(f"{runs[w]['seconds']:.1f} s" for w in worlds)
    print(f"parallel: ran NCCL at world 1 {multi}; {cards} card(s) here; {secs} | {card}",
          flush=True)
    runs["two_axis"] = phase_two_axis(torch, card, folder)
    return runs


# The two-axis part of the parallel phase: 4 ranks on a data 2 x model 2 mesh,
# NCCL where the machine has 4 cards, else gloo on the one card (its collectives
# through the host) where the probe finds that gloo takes CUDA tensors.
TWO_AXIS_ROUNDS = 3  # chunks of each path in turns; the first is dropped
TWO_AXIS_STEPS = 4  # steps a timed chunk
PROBE_TIMEOUT = 90  # a collective that one rank refuses leaves the other waiting
LSQ_SHARD_STEP_TOL = 1e-4  # relative; the CPU sees 3.5e-6


def phase_two_axis(torch, card, folder):
    """The LSQ-mode kernel on shards (:func:`phase_lsq_shards`, one card);
    probe gloo with CUDA tensors (2 ranks on the card: all_gather,
    all_reduce, broadcast and the ring's batched sends), then run
    :func:`two_axis_rank` on 4 ranks and ``cli/multichip.py`` at n 1 and
    n 4 where NCCL (4 cards) or the probe allows; a line says what ran."""
    from channelestimationtransformer_torch.ops.cuda import quant
    from channelestimationtransformer_torch.ops.quant import codebooks, lsq
    from channelestimationtransformer_torch.parallel.launch import run_local

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    shards = phase_lsq_shards(torch, quant, lsq, codebooks)
    probe = {} if cards >= 4 else gloo_probe(run_local, t0)
    backend = "nccl" if cards >= 4 else "gloo"
    collectives = cards >= 4 or all(probe[op] == "ok" for op in GLOO_OPS[:3])
    p2p = cards >= 4 or probe["p2p"] == "ok"
    run = {"probe": probe, "backend": backend, "cards": cards, "lsq_shards": shards,
           "four_ranks": collectives}
    if collectives:
        t1 = time.perf_counter()
        path = folder / "two_axis.json"
        try:
            outs = run_local([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--two-axis-rank", str(path), backend], 4,
                             timeout=PARALLEL_TIMEOUT)
        except RuntimeError as e:
            fail(f"two-axis phase, 4 ranks ({backend}): {e}")
        print(outs[0], end="", flush=True)
        result = json.loads(path.read_text())
        missing = {"step", "lsq_step", "resume"} - result.keys()
        if missing:
            fail(f"two-axis phase, 4 ranks ({backend}): no result for {sorted(missing)}")
        run.update(result, seconds=time.perf_counter() - t1)
    from channelestimationtransformer_torch.cli import multichip

    run["multichip"] = {}
    for n in (1, 4):
        if n == 4 and not (collectives and p2p):
            continue
        argv = ["--n-devices", str(n), "--timeout", str(PARALLEL_TIMEOUT)]
        with contextlib.redirect_stdout(io.StringIO()) as text:
            result = multichip.main(argv)
        ok = (result["ok"] and math.isfinite(result["train_loss"])
              and math.isfinite(result["ring_loss"]) and result["ring_grads_finite"]
              and result["dataset_finite"] and result["h_eff_finite"])
        print(f"driver phase: cli.multichip --n-devices {n} ({result['backend']}, model axis "
              f"{result['model_axis']}): {result['seconds']:.1f} s; train loss "
              f"{result['train_loss']:.6f}, ring loss {result['ring_loss']:.3f}, dataset shard "
              f"{result['dataset_shard']}, h_eff {result['h_eff']}, finite "
              f"{ok} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or text.getvalue().strip().splitlines()[-1] != json.dumps(result):
            fail(f"cli.multichip at n {n} failed or printed no result line")
        run["multichip"][n] = result
    ran = ("4 ranks (" + backend + (" on one card" if cards < 4 else "") + ")" if collectives
           else "no 4-rank run (gloo refused CUDA tensors and fewer than 4 cards)")
    print(f"two-axis phase: {ran}; cli.multichip at n {sorted(run['multichip'])}; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    run["seconds"] = time.perf_counter() - t0
    return run


def two_axis_rank(out_path, backend):
    """One of 4 ranks on a data 2 x model 2 mesh (``backend``: NCCL on 4
    cards, gloo on one): the flagship step and the LSQ-fibbinary flagship
    step against one card's (:func:`_two_axis_step`), then the resume
    check (:func:`_two_axis_resume`); rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import mha_attention as mha
    from channelestimationtransformer_torch.ops.cuda import quant
    from channelestimationtransformer_torch.parallel.launch import join_local

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = join_local("cuda", backend=backend)
    rank = dist.get_rank()
    wrappers = dict(bd_fwd=ops.bd_attention_fwd, bd_bwd=ops.bd_attention_bwd,
                    mha=mha.mha_attention_fwd, codeword=quant.fused_nearest_codeword)

    def log(*args, **kwargs):
        if rank == 0:
            print(*args, **kwargs)

    result = dict(world=dist.get_world_size(), backend=backend,
                  card=torch.cuda.get_device_name())
    result["step"] = _two_axis_step(torch, wrappers, device, log, lsq=False)
    result["lsq_step"] = _two_axis_step(torch, wrappers, device, log, lsq=True)
    result["resume"] = _two_axis_resume(torch, device, log)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(result, indent=1))
    dist.barrier()
    dist.destroy_process_group()


def _two_axis_step(torch, wrappers, device, log, lsq):
    """One ``_update`` of the flagship (``lsq``: the LSQ-fibbinary flagship;
    kernels on, dropout 0) on a data 2 x model 2 mesh, the global batch 256
    split over ``data``, against one card's ``_update`` on the whole batch
    on rank 0 (max pooling routed as the mesh's): loss, every gradient
    (shards gathered) and the BatchNorm statistics; the replicated
    gradients equal across the model group; 13 + 13 bd launches a rank (LSQ:
    and 72 + 72 codeword, the LSQ mode on the rank's rows). The flagship
    then times a 2 x 2 chunk beside one card's ``train_chunk`` of the same
    global batch, in turns."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.parallel.tensor import (
        gather_rows,
        replicated_grads_equal,
        sharded_names,
        tensor_parallel,
    )
    from channelestimationtransformer_torch.train.trainer import (
        _update,
        create_train_state,
        train_chunk,
        train_chunk_dp,
    )

    cfg = (InformerConfig(attn="full", use_pallas=True, lsq_nbits=LSQ_NBITS, lsq_fibbinary=True,
                          dropout=0.0) if lsq else InformerConfig(use_pallas=True, dropout=0.0))
    name = "lsq-fibbinary" if lsq else "flagship"
    mesh = make_mesh(data=2, model=2)
    dg, mg = mesh.get_group("data"), mesh.get_group("model")
    d, per, tc = dist.get_rank(dg), 128, TrainConfig(batch_size=256, lr=1e-4)
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    batch = make_batch(ds, 256, cfg.label_len, generator=gen(8))  # the same on every rank
    model = tensor_parallel(build_informer(cfg, device=device, seed=0), mesh)
    state = create_train_state(model, tc)
    routing = []
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    with _maxpool_routing(torch, routing):
        metrics = _update(state, *(t[d * per:(d + 1) * per] for t in batch), gen(20), dg)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    sharded = sharded_names(model)
    grads = {n: gather_rows(p.grad, mg) if n in sharded else p.grad.clone()
             for n, p in model.named_parameters()}
    equal = replicated_grads_equal(model)
    routes = [_gather_batch(torch, idx, dg) for idx in routing]
    expected = dict(bd_fwd=13, bd_bwd=13, mha=0, codeword=2 * 72 if lsq else 0)
    out = dict(launches=launches, sharded=len(sharded), replicated_grads_equal=equal)
    if dist.get_rank() == 0:
        single = create_train_state(build_informer(cfg, device=device, seed=0), tc)
        with _maxpool_routing(torch, routes, replay=True) as flips:
            m_one = _update(single, *batch, gen(20))
        want = _grads(single.model)
        floor = 1e-3 * max(g.abs().max().item() for g in want.values())
        grad_err = max(_grad_errors(grads, want, floor).values())
        stats = {k: v for k, v in single.model.state_dict().items() if "running" in k}
        stat_err = _state_errors(torch, model.state_dict(), stats, "float32")
        loss = (metrics["loss"].item(), m_one["loss"].item())
        ok = (abs(loss[0] - loss[1]) <= MAIN_TOL[0] * abs(loss[1]) and grad_err <= GRAD_TOL
              and stat_err <= MAIN_TOL[1] and equal and launches == expected)
        log(f"two-axis {name} step (data 2 x model 2, 4 ranks; {len(sharded)} weights sharded, "
            f"128 windows a data rank, dropout 0) vs one card's _update on the whole 256: loss "
            f"{loss[0]:.6f} vs {loss[1]:.6f}, gradients (shards gathered) worst {grad_err:.3e} "
            f"(limit {GRAD_TOL}; max pooling routed as the mesh's, {sum(flips)} windows "
            f"differ), BatchNorm statistics worst {stat_err:.3e} (limit {MAIN_TOL[1]}); "
            f"replicated gradients equal across the model group {equal}; launches on rank 0 "
            f"{_launch_report(launches, expected)} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the two-axis {name} step disagrees with one card's or launched {launches}")
        out.update(loss=loss, grad_err=grad_err, stat_err=stat_err)
    dist.barrier()
    if lsq:
        return out
    rows = ds.num_samples // 2
    shard = WindowDataset(h=ds.h[d * rows:(d + 1) * rows], seq_len=cfg.seq_len,
                          pred_len=cfg.pred_len, snr_db=ds.snr_db, device=device)
    single = create_train_state(build_informer(cfg, device=device, seed=0), tc)
    times = {"two_axis": [], "single": []}
    for i in range(TWO_AXIS_ROUNDS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_chunk_dp(state, shard, num_steps=TWO_AXIS_STEPS, per_device_batch=per,
                       label_len=cfg.label_len, generator=gen(100 + 2 * i + d), group=dg)
        torch.cuda.synchronize()
        times["two_axis"].append(time.perf_counter() - t0)
        dist.barrier()
        if dist.get_rank() == 0:
            t0 = time.perf_counter()
            train_chunk(single, ds, num_steps=TWO_AXIS_STEPS, batch_size=256,
                        label_len=cfg.label_len, generator=gen(200 + i))
            torch.cuda.synchronize()
            times["single"].append(time.perf_counter() - t0)
    ms = {path: 1e3 * statistics.median(ts[1:]) / TWO_AXIS_STEPS for path, ts in times.items()
          if ts}
    if "single" in ms:
        log(f"two-axis flagship: {ms['two_axis']:.1f} ms a step of the global batch 256 on the "
            f"data 2 x model 2 mesh (4 ranks), one card's train_chunk {ms['single']:.1f} ms a "
            f"step (median of {TWO_AXIS_ROUNDS - 1} chunks of {TWO_AXIS_STEPS}, in turns)",
            flush=True)
    return dict(out, ms_per_step=ms)


# The resume check's limit on Adam's moments (each tensor's max abs
# difference over its own max abs, floored at 1e-3 of the largest): the
# sound resume reads far below it (cuDNN's conv backward alone), a resume
# that lost the moments far above (half of 4 steps' sums), which the check
# plants and reads in every run.
MOMENT_TOL = 0.05


def _two_axis_resume(torch, device, log):
    """``Trainer`` on a data 2 x model 2 mesh (the flagship, kernels on,
    dropout 0.05, 2 steps an epoch): two epochs against one epoch, its
    gathered checkpoint, ``load_checkpoint`` into a new tensor-parallel
    Trainer and ``fit(start_epoch=1)``: the last validation NMSE within
    ``MAIN_TOL``, the parameters within the run's Adam steps times its lr,
    and Adam's moments (gathered) within ``MOMENT_TOL`` (said: whether bit
    for bit). A third run resumes with the moments dropped (a planted
    fault), which the moment check must see."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.parallel.tensor import full_state_dicts
    from channelestimationtransformer_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )
    from channelestimationtransformer_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = InformerConfig(use_pallas=True)
    mesh = make_mesh(data=2, model=2)
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096)
    train, val = (WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                                snr_db=ds.snr_db, device=device) for h in (ds.h[:3584],
                                                                           ds.h[3584:]))
    folder = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(folder)
    tc = TrainConfig(batch_size=256, num_epochs=2, steps_per_epoch=2, log_every=2,
                     checkpoint_every_epochs=1, checkpoint_dir=folder[0])

    def trainer(tc):
        return Trainer(build_informer(cfg, device=device, seed=0), cfg, tc, train, val,
                       mesh=mesh, log=lambda msg: None)

    def resume(path, drop_moments):
        t = trainer(tc)
        t.state, epoch, _ = load_checkpoint(path, t.state)
        step = t.state.step
        if drop_moments:
            t.state.optimizer.state.clear()
        return t, t.fit(start_epoch=1), epoch, step

    whole = trainer(dataclasses.replace(tc, checkpoint_every_epochs=0))
    hist_whole = whole.fit()
    trainer(tc).fit(num_epochs=1)
    path = latest_checkpoint(folder[0], "tmodel_")  # epoch 1's, before the resumed runs write
    resumed, hist_resumed, epoch, step = resume(path, False)
    planted, hist_planted, _, _ = resume(path, True)
    a, ra, pa = (full_state_dicts(t.model, t.state.optimizer)
                 for t in (whole, resumed, planted))
    dist.barrier()
    if dist.get_rank() != 0:
        return {}
    shutil.rmtree(folder[0])

    def moments(got, want):
        """Worst over exp_avg and exp_avg_sq of each tensor's error (see MOMENT_TOL)."""
        worst = 0.0
        for key in ("exp_avg", "exp_avg_sq"):
            g, w = ([st[key] for _, st in sorted(o["state"].items())] for o in (got, want))
            floor = 1e-3 * max(t.abs().max().item() for t in w)
            worst = max(worst, max(_grad_errors(dict(enumerate(g)), dict(enumerate(w)),
                                                floor).values()))
        return worst

    nmse = (hist_whole[-1]["nmse"], hist_resumed[-1]["nmse"], hist_planted[-1]["nmse"])
    worst, planted_worst = (_state_errors(torch, b[0], a[0], "float32") for b in (ra, pa))
    moment, planted_moment = moments(ra[1], a[1]), moments(pa[1], a[1])
    bits = all(torch.equal(a[0][k], ra[0][k]) for k in a[0]) and nmse[0] == nmse[1]
    bound = tc.lr * tc.num_epochs * tc.steps_per_epoch
    ok = (epoch == 1 and step == 2 and worst <= bound and moment <= MOMENT_TOL
          and abs(nmse[0] - nmse[1]) <= MAIN_TOL[0] * abs(nmse[0]))
    seen = planted_moment > MOMENT_TOL
    log(f"two-axis resume (Trainer, data 2 x model 2, flagship, kernels on, dropout 0.05, 2 "
        f"epochs of 2 steps): resumed at epoch {epoch} from the gathered checkpoint; last "
        f"validation NMSE {nmse[1]:.6f} vs {nmse[0]:.6f} uninterrupted, parameters worst "
        f"{worst:.3e} (limit {bound:.0e}), Adam moments worst {moment:.3e} (limit "
        f"{MOMENT_TOL}), bit for bit {bits}; planted fault (moments dropped on resume): NMSE "
        f"{nmse[2]:.6f}, parameters {planted_worst:.3e}, moments {planted_moment:.3e}, seen "
        f"{seen}; {time.perf_counter() - t0:.1f} s {'ok' if ok and seen else 'MISMATCH'}",
        flush=True)
    if not ok:
        fail("the resumed two-axis run does not end where the uninterrupted run ends")
    if not seen:
        fail("the resume check does not see a resume that drops Adam's moments")
    return dict(nmse=nmse, worst=worst, moments=moment, bit_for_bit=bits,
                planted=dict(worst=planted_worst, moments=planted_moment),
                seconds=time.perf_counter() - t0)


def phase_lsq_shards(torch, quant, lsq, cbm):
    """The LSQ-fibbinary layer at a model axis of 2 and 4, on one card: each
    rank's rows of the flagship's three LSQ weight shapes through
    ``lsq_quantize`` with the whole weight's ``numel`` (the LSQ-mode launch
    a ``DenseLSQ`` shard makes) against the whole weight's, values and
    weight gradients bit for bit, the ``step_size`` gradients summed over
    the ranks within ``LSQ_SHARD_STEP_TOL`` of the whole's (another order of
    one sum, which cancels ~1e4-fold, as ``tests/test_torch_lsq.py`` says); how
    many values the shard's own ``numel`` would change is printed."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(7)
    cb_np = np.asarray(cbm.lsq_fibbinary_codebook(LSQ_NBITS))
    cb = torch.tensor(cb_np, dtype=torch.float32, device="cuda")
    checks, launches, own_numel, step_err = 0, 0, 0, 0.0
    for label, shape, _ in LSQ_SHAPES:
        w = _lsq_weight(torch, np, shape, cb_np, gen).nan_to_num(0.0)
        cot = torch.randn(shape, generator=gen, device="cuda")
        for step_value in (LSQ_STEP, LSQ_STEP * 1.37):
            step = torch.tensor(step_value, device="cuda", requires_grad=True)
            whole_w = w.clone().requires_grad_()
            whole = lsq.lsq_quantize(whole_w, step, LSQ_NBITS, cb)
            (whole * cot).sum().backward()
            want_step = step.grad.clone()
            for n in (2, 4):
                rows = shape[0] // n
                step_sum = torch.zeros((), device="cuda")
                for r in range(n):
                    part = slice(r * rows, (r + 1) * rows)
                    step.grad = None
                    shard = w[part].clone().requires_grad_()
                    quant.fused_nearest_codeword.launches = 0
                    got = lsq.lsq_quantize(shard, step, LSQ_NBITS, cb, numel=w.numel())
                    (got * cot[part]).sum().backward()
                    launches += quant.fused_nearest_codeword.launches
                    step_sum += step.grad
                    if not (torch.equal(got, whole[part].detach())
                            and torch.equal(shard.grad, whole_w.grad[part])):
                        fail(f"LSQ mode on rows {part} of {label} (model axis {n}) differs from "
                             "the whole weight's rows")
                    with torch.no_grad():
                        own = lsq.lsq_quantize(w[part], step, LSQ_NBITS, cb)
                    own_numel += int((own != whole[part]).sum())
                    checks += 1
                step_err = max(step_err, ((step_sum - want_step).abs()
                                          / want_step.abs().clamp_min(1e-30)).item())
    ok = step_err <= LSQ_SHARD_STEP_TOL
    print(f"codeword lsq mode on shards (model axis 2 and 4, {len(LSQ_SHAPES)} shapes x 2 step "
          f"sizes, nbits {LSQ_NBITS}): {checks} shards' values and weight gradients = the whole "
          f"weight's rows bit for bit; step_size gradients summed over the shards within "
          f"{step_err:.2e} of the whole's (limit {LSQ_SHARD_STEP_TOL}); {launches} codeword "
          f"launches (forward and backward); with the shard's own numel {own_numel} values "
          f"would differ "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the step_size gradient of LSQ shards does not sum to the whole weight's")
    return dict(shards=checks, launches=launches, step_rel_err=step_err,
                own_numel_differs=own_numel)


GLOO_OPS = ("all_gather", "all_reduce", "broadcast", "p2p")
# gloo's own answer to a CUDA tensor it does not take: an error that names
# gloo or the device type, or a rank ended by an uncaught exception of
# gloo's C++ code (std::terminate's "what():" and gloo's source path; this
# torch's batched sends end so). The peer's "Connection closed" that
# follows any death is neither.
GLOO_REFUSAL = re.compile(r"gloo|device type|CUDA tensor", re.I)
GLOO_ABORT = re.compile(r"what\(\):\s+\[[^\]]*[/\\]gloo[/\\]")


def gloo_probe(run_local, t0):
    """Whether gloo takes CUDA tensors for each op of :data:`GLOO_OPS`, from
    :func:`gloo_probe_rank` on 2 ranks of the card: ``{op: "ok" | "refused"
    | "not tried"}``, and a line that says so. An op is refused only where
    it started and then raised gloo's error, or a rank died inside it with
    gloo's transport abort (the ops after it are then not tried); a rank
    that dies after rank 0 saw gloo refuse the op it started last (the
    closing barrier on the pair that op broke) is that refusal. Anything
    else (no op started, a wrong value, another error, a timeout) fails the
    phase."""
    argv = [sys.executable, str(pathlib.Path(__file__).resolve()), "--gloo-probe-rank"]
    try:
        text, died = "".join(run_local(argv, 2, timeout=PROBE_TIMEOUT)), None
    except RuntimeError as e:  # the ranks' outputs follow the first line
        head, _, text = str(e).partition("\n")
        died = head
    verdict = dict.fromkeys(GLOO_OPS, "not tried")
    last = None  # the op that rank 0 started last
    for op, what in re.findall(r"^probe (\w+) (start|True|refused|wrong)", text, re.M):
        if what == "wrong":
            fail(f"gloo probe: {op} on CUDA tensors gave wrong values:\n{text}")
        if what == "start":
            last, verdict[op] = op, "no answer"
        else:
            verdict[op] = "ok" if what == "True" else "refused"
    if died is not None:  # a rank that dies in gloo's transport takes its peer with it
        abort = next((line.strip() for line in text.splitlines() if GLOO_ABORT.search(line)),
                     None)
        refused = last is not None and verdict[last] == "refused"
        if last is None or verdict[last] == "ok" or (abort is None and not refused):
            fail(f"gloo probe failed, and not by gloo refusing an op it had started "
                 f"({died}):\n{text}")
        verdict[last] = "refused"
        died = abort or f"after gloo refused it, the ranks' closing barrier ({died})"
    elif set(verdict.values()) - {"ok", "refused"}:
        fail(f"gloo probe ended without an answer for every op:\n{text}")
    print("two-axis: gloo with CUDA tensors on one card (2 ranks): "
          + ", ".join(f"{op} {v}" for op, v in verdict.items())
          + (f"; a rank died in {last}: {died}" if died else "")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(verdict, died=died)


def gloo_probe_rank():
    """One of 2 gloo ranks on the card: each op of :data:`GLOO_OPS` on CUDA
    tensors, its values checked. Rank 0 prints ``probe <op> start`` before
    each and then ``True``, ``wrong`` (values off) or ``refused`` (gloo's
    error, :data:`GLOO_REFUSAL`); any other error ends the rank."""
    import torch
    import torch.distributed as dist

    from channelestimationtransformer_torch.parallel.launch import join_local

    device = join_local("cuda", backend="gloo")
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=device)
    for op in GLOO_OPS:
        if r == 0:
            print(f"probe {op} start", flush=True)
        try:
            if op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x)
                ok = all(float(p[0]) == i + 1 for i, p in enumerate(parts))
            elif op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = float(y[0]) == n * (n + 1) / 2
            elif op == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                ok = float(y[0]) == 1.0
            else:
                y = torch.empty_like(x)
                reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (r + 1) % n),
                                               dist.P2POp(dist.irecv, y, (r - 1) % n)])
                for req in reqs:
                    req.wait()
                ok = float(y[0]) == (r - 1) % n + 1
            torch.cuda.synchronize()
            answer = "True" if ok else "wrong"
        except RuntimeError as e:
            if not GLOO_REFUSAL.search(str(e)):
                raise
            answer = f"refused: {str(e).splitlines()[0]}"
        if r == 0:
            print(f"probe {op} {answer}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _state_errors(torch, got, want, dtype):
    """Worst difference over the floating tensors of two ``state_dict``s:
    max abs in f32, max abs over the tensor's max abs in bf16."""
    worst = 0.0
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        diff = (got[name].float() - w.float()).abs().max().item()
        worst = max(worst, diff if dtype == "float32"
                    else diff / max(w.float().abs().max().item(), 1e-30))
    return worst


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _dp_world1(torch, wrappers, device, dtype, log):
    """``train_chunk_dp`` at world 1 against ``train_chunk`` at the flagship
    (batch 256, dropout 0.05) from the same weights, batch and generator
    seeds, so the same draws and masks. First one step (``_update`` with and
    without the group) with max pooling routed as the DP step's, as the
    train phase pins it: loss, every gradient, the BatchNorm statistics.
    Then a chunk of each from there: 13 + 13 bd launches a DP step, the
    chunk's loss and the whole state (f32: ``MAIN_TOL`` and ``GRAD_TOL``;
    bf16: ``BF16_TOL[0]`` of the max and ``BF16_GRAD_CAP``), beside
    ``train_chunk`` run twice (the f32 path is not bit-reproducible: a
    max-pooling window near a tie routes its gradient either way); samples/s
    of both in turns."""
    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.train.trainer import (
        _update,
        create_train_state,
        train_chunk,
        train_chunk_dp,
    )

    cfg = InformerConfig(use_pallas=True, dtype=dtype)
    group = make_mesh().get_group("data")
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len)
    tc = TrainConfig(batch_size=256, lr=1e-4)
    states = {path: create_train_state(build_informer(cfg, device=device, seed=0), tc)
              for path in ("dp", "single", "again")}

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # (a) One step, routing pinned.
    batch = make_batch(ds, 256, cfg.label_len, generator=gen(3))
    routing, steps, flips = [], {}, {}
    for path in states:
        with _maxpool_routing(torch, routing, replay=path != "dp") as flips[path]:
            steps[path] = _update(states[path], *batch, gen(4), group if path == "dp" else None)
    models = {path: s.model for path, s in states.items()}
    grads = {path: _grads(m) for path, m in models.items()}
    floor = (1e-3 if dtype == "float32" else BF16_GRAD_FLOOR) * max(
        g.abs().max().item() for g in grads["single"].values())
    step_loss = {path: m["loss"].item() for path, m in steps.items()}
    grad_err = max(_grad_errors(grads["dp"], grads["single"], floor).values())
    stats = {k: v for k, v in models["single"].state_dict().items() if "running" in k}
    stat_err = _state_errors(torch, models["dp"].state_dict(), stats, "float32")

    # (b) A chunk of each from there, the same generator seed.
    def run(path, seed):
        if path == "dp":
            return train_chunk_dp(states[path], ds, num_steps=TRAIN_STEPS, per_device_batch=256,
                                  label_len=cfg.label_len, generator=gen(seed), group=group)
        return train_chunk(states[path], ds, num_steps=TRAIN_STEPS, batch_size=256,
                           label_len=cfg.label_len, generator=gen(seed))

    torch.cuda.synchronize()
    _zero_counts(wrappers)
    m_dp = run("dp", 5)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    m_one = run("single", 5)
    run("again", 5)
    expected = dict(bd_fwd=13 * TRAIN_STEPS, bd_bwd=13 * TRAIN_STEPS, mha=0)
    loss_dp, loss_one = (m["loss_sum"].item() / TRAIN_STEPS for m in (m_dp, m_one))
    state_err, state_spread = (
        _state_errors(torch, models[path].state_dict(), models["single"].state_dict(), dtype)
        for path in ("dp", "again"))
    if dtype == "float32":
        loss_tol, cap, stat_cap = MAIN_TOL[0], GRAD_TOL, MAIN_TOL[1]
        state_ok = all(torch.allclose(a, b, rtol=MAIN_TOL[0], atol=MAIN_TOL[1])
                       for a, b in zip(models["dp"].state_dict().values(),
                                       models["single"].state_dict().values())
                       if a.is_floating_point())
        limits = f"rtol {MAIN_TOL[0]}, atol {MAIN_TOL[1]}"
    else:
        loss_tol, cap, stat_cap = 1e-2, BF16_GRAD_CAP, BF16_TOL[0]
        state_ok = state_err <= BF16_TOL[0]
        limits = f"{BF16_TOL[0]} of the max"
    ok = (abs(step_loss["dp"] - step_loss["single"]) <= loss_tol * abs(step_loss["single"])
          and grad_err <= cap and stat_err <= stat_cap and state_ok and launches == expected
          and abs(loss_dp - loss_one) <= loss_tol * abs(loss_one) and math.isfinite(loss_dp))
    log(f"parallel world 1 (NCCL) {dtype}: one step, _update with the group vs without (same "
        f"weights, batch, masks; max pooling routed as the DP step's, {sum(flips['single'])} "
        f"windows differ from the other's own argmax): loss {step_loss['dp']:.6f} vs "
        f"{step_loss['single']:.6f}, gradients worst {grad_err:.3e} (limit {cap}), BatchNorm "
        f"statistics worst {stat_err:.3e} (limit {stat_cap}); then train_chunk_dp "
        f"{TRAIN_STEPS} x 256 vs train_chunk: loss {loss_dp:.6f} vs {loss_one:.6f}, state worst "
        f"{state_err:.3e} ({limits}; train_chunk run twice: {state_spread:.3e}); launches "
        f"{_launch_report(launches, expected)} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"train_chunk_dp at world 1 ({dtype}) disagrees with train_chunk or launched "
             f"{launches}")
    times = _alternate(torch, lambda path, i: run(path, 100 + i), rounds=PARALLEL_ROUNDS,
                       names=("dp", "single"))
    rate = {path: TRAIN_STEPS * 256 / statistics.median(ts[1:]) for path, ts in times.items()}
    log(f"parallel world 1 {dtype}: train_chunk_dp {rate['dp']:.1f} samples/s, train_chunk "
        f"{rate['single']:.1f} (median of {PARALLEL_ROUNDS - 1} chunks of {TRAIN_STEPS} x 256, "
        f"in turns)", flush=True)
    return dict(launches=launches, step_loss=step_loss, grad_err=grad_err, stat_err=stat_err,
                loss=(loss_dp, loss_one), state_err=state_err, state_spread=state_spread,
                samples_per_s=rate,
                chunk_ms={path: [t * 1e3 for t in ts] for path, ts in times.items()})


def _gather_batch(torch, t, group):
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _dp_ranks(torch, wrappers, device, dtype, log):
    """One DP ``_update`` at the flagship widths (dropout 0: each rank's
    masks would be its own), global batch 256 split over the ranks, each
    part drawn from the rank's shard, against one card's ``_update`` on the
    concatenated batch on rank 0 (max pooling routed as the ranks'): loss,
    gradients, BatchNorm statistics; then a DP chunk's launches on every
    rank and its samples/s beside one card's chunk of the same global batch."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.train.trainer import (
        _update,
        create_train_state,
        train_chunk,
        train_chunk_dp,
    )

    cfg = InformerConfig(use_pallas=True, dtype=dtype, dropout=0.0)
    group = make_mesh().get_group("data")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    per, tc = 256 // n, TrainConfig(batch_size=256, lr=1e-4)
    full = _card_data(torch, cfg.seq_len, cfg.pred_len)
    rows = full.num_samples // n
    shard = WindowDataset(h=full.h[r * rows:(r + 1) * rows], seq_len=cfg.seq_len,
                          pred_len=cfg.pred_len, snr_db=full.snr_db, device=device)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    state = create_train_state(build_informer(cfg, device=device, seed=0), tc)
    batch = make_batch(shard, per, cfg.label_len, generator=gen(10 + r))
    routing = []
    with _maxpool_routing(torch, routing):
        m_dp = _update(state, *batch, gen(20), group)
    whole = [_gather_batch(torch, t, group) for t in batch]
    routes = [_gather_batch(torch, idx, group) for idx in routing]
    out = {}
    if r == 0:
        single = create_train_state(build_informer(cfg, device=device, seed=0), tc)
        with _maxpool_routing(torch, routes, replay=True) as flips:
            m_one = _update(single, *whole, gen(20))
        g_dp, g_one = _grads(state.model), _grads(single.model)
        floor = (1e-3 if dtype == "float32" else BF16_GRAD_FLOOR) * max(
            g.abs().max().item() for g in g_one.values())
        grad_err = max(_grad_errors(g_dp, g_one, floor).values())
        stats = {k: v for k, v in single.model.state_dict().items() if "running" in k}
        stat_err = _state_errors(torch, state.model.state_dict(), stats, dtype)
        loss_dp, loss_one = m_dp["loss"].item(), m_one["loss"].item()
        tol = MAIN_TOL[0] if dtype == "float32" else 1e-2
        cap = GRAD_TOL if dtype == "float32" else BF16_GRAD_CAP
        stat_cap = MAIN_TOL[1] if dtype == "float32" else BF16_TOL[0]
        ok = (abs(loss_dp - loss_one) <= tol * abs(loss_one) and grad_err <= cap
              and stat_err <= stat_cap)
        log(f"parallel world {n} (NCCL) {dtype}: one DP _update ({per} windows a rank from its "
            f"shard) vs one card's _update on the concatenated 256: loss {loss_dp:.6f} vs "
            f"{loss_one:.6f} (rtol {tol}), gradients worst {grad_err:.3e} (limit {cap}), "
            f"BatchNorm statistics worst {stat_err:.3e} (limit {stat_cap}); max pooling routed "
            f"as the ranks' ({sum(flips)} windows differ from one card's own argmax) "
            f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the DP step on {n} ranks ({dtype}) disagrees with one card's")
        out.update(loss=(loss_dp, loss_one), grad_err=grad_err, stat_err=stat_err)
    dist.barrier(group)
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    train_chunk_dp(state, shard, num_steps=TRAIN_STEPS, per_device_batch=per,
                   label_len=cfg.label_len, generator=gen(30 + r), group=group)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    expected = dict(bd_fwd=13 * TRAIN_STEPS, bd_bwd=13 * TRAIN_STEPS, mha=0)
    if launches != expected:
        fail(f"train_chunk_dp on rank {r} of {n} launched {launches}, not {expected}")
    times = {"dp": [], "single": []}
    single = create_train_state(build_informer(cfg, device=device, seed=0), tc) if r == 0 else None
    for i in range(PARALLEL_ROUNDS):
        dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_chunk_dp(state, shard, num_steps=TRAIN_STEPS, per_device_batch=per,
                       label_len=cfg.label_len, generator=gen(100 + i), group=group)
        torch.cuda.synchronize()
        times["dp"].append(time.perf_counter() - t0)
        if r == 0:
            t0 = time.perf_counter()
            train_chunk(single, full, num_steps=TRAIN_STEPS, batch_size=256,
                        label_len=cfg.label_len, generator=gen(200 + i))
            torch.cuda.synchronize()
            times["single"].append(time.perf_counter() - t0)
    rate = {path: TRAIN_STEPS * 256 / statistics.median(ts[1:]) for path, ts in times.items()
            if ts}
    if r == 0:
        log(f"parallel world {n} {dtype}: launches on rank 0 "
            f"{_launch_report(launches, expected)}; "
            f"train_chunk_dp {rate['dp']:.1f} samples/s across {n} cards, one card's "
            f"train_chunk {rate['single']:.1f} (global batch 256, median of "
            f"{PARALLEL_ROUNDS - 1} chunks)", flush=True)
    return dict(out, launches=launches, samples_per_s=rate)


def _ring_vs_full(torch, wrappers, device, log):
    """The ring Informer (``RING_CFG``, eval, batch 64) with its sequence on
    every rank's ``seq`` axis against the full model with the same weights
    on the same batch (``MAIN_TOL``); its launches (the decoder's 6 calls on
    mha, the encoder's 7 ring calls on none) and ms a batch beside the full
    model's, in turns."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    cfg = InformerConfig(use_pallas=True, attn="ring", **RING_CFG)
    models = {"ring": build_informer(cfg, device=device, seed=0,
                                     mesh=make_mesh(data=1, model=1, seq=n)),
              "full": build_informer(dataclasses.replace(cfg, attn="full"), device=device,
                                     seed=0)}
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096, slots=cfg.seq_len + 10)
    x_enc, x_dec, _ = make_batch(ds, RING_BATCH, cfg.label_len,
                                 generator=torch.Generator(device=device).manual_seed(2))
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    with torch.no_grad():
        out_ring = models["ring"](x_enc, x_dec)
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    with torch.no_grad():
        out_full = models["full"](x_enc, x_dec)
    expected = dict(bd_fwd=0, bd_bwd=0, mha=2 * cfg.d_layers)
    text, ok, err = _close(torch, out_ring, out_full, "float32")
    ok = ok and launches == expected
    log(f"parallel ring (world {n}, seq axis {n}; d_model {cfg.d_model}, E "
        f"{cfg.d_model // cfg.n_heads}, seq_len {cfg.seq_len}, distil off, eval x {RING_BATCH}) "
        f"vs the full model: {text}; launches {_launch_report(launches, expected)} "
        f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"the ring Informer on {n} rank(s) disagrees with the full model or launched "
             f"{launches}")

    def run(path, i):
        with torch.no_grad():
            models[path](x_enc, x_dec)
    times = _alternate(torch, run, rounds=PARALLEL_ROUNDS + 2, names=("ring", "full"))
    ms = {path: statistics.median(ts[1:]) * 1e3 for path, ts in times.items()}
    log(f"parallel ring (world {n}): {ms['ring']:.3f} ms a batch of {RING_BATCH}, full model "
        f"{ms['full']:.3f} (median of {PARALLEL_ROUNDS + 1}, in turns)", flush=True)
    return dict(launches=launches, max_abs=err, ms=ms)


# Ring training: the flagship widths with distil off (JAX's ring refuses the
# distilling convs), dropout 0 (the ring drops no attention probabilities,
# as JAX's), seq_len 80 (divisible by 4 ranks in both encoders; the
# encoders' 80 + 40 slots are keys the bd kernel takes in the decoder's
# cross-attention), batch 64.
RING_TRAIN_CFG = dict(seq_len=80, distil=False, dropout=0.0)
RING_TRAIN_BATCH = 64


def _ring_train(torch, wrappers, device, log):
    """One ``_update`` of the ring model (``RING_TRAIN_CFG``, its encoder's
    sequence on every rank's ``seq`` axis) against the full model's with the
    same weights and batch: loss, every gradient (``GRAD_TOL`` of the f32
    step checks); the ring model's kernel launches (its decoder's 6 calls on
    the bd forward and backward, the encoder's 7 ring calls on none) and the
    full model's 13 + 13."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.train.trainer import _update, create_train_state

    n = dist.get_world_size()
    cfg = InformerConfig(use_pallas=True, attn="ring", **RING_TRAIN_CFG)
    tc = TrainConfig(batch_size=RING_TRAIN_BATCH, lr=1e-4)
    mesh = make_mesh(data=1, model=1, seq=n)
    states = {"ring": create_train_state(build_informer(cfg, device=device, seed=0, mesh=mesh),
                                         tc),
              "full": create_train_state(build_informer(dataclasses.replace(cfg, attn="full"),
                                                        device=device, seed=0), tc)}
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096, slots=cfg.seq_len + 10)
    batch = make_batch(ds, RING_TRAIN_BATCH, cfg.label_len,
                       generator=torch.Generator(device=device).manual_seed(6))
    metrics, launches = {}, {}
    for path, state in states.items():
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        metrics[path] = _update(state, *batch, torch.Generator(device=device).manual_seed(7))
        torch.cuda.synchronize()
        launches[path] = _counts(wrappers)
    grads = {path: _grads(s.model) for path, s in states.items()}
    floor = 1e-3 * max(g.abs().max().item() for g in grads["full"].values())
    grad_err = max(_grad_errors(grads["ring"], grads["full"], floor).values())
    loss = {path: m["loss"].item() for path, m in metrics.items()}
    calls = 2 * cfg.d_layers
    expected = dict(bd_fwd=calls, bd_bwd=calls, mha=0)
    full_calls = len(attention_calls(cfg))
    ok = (abs(loss["ring"] - loss["full"]) <= MAIN_TOL[0] * abs(loss["full"])
          and grad_err <= GRAD_TOL and launches["ring"] == expected
          and launches["full"] == dict(bd_fwd=full_calls, bd_bwd=full_calls, mha=0))
    log(f"parallel ring training (world {n}, seq axis {n}; flagship widths, seq_len "
        f"{cfg.seq_len}, distil off, dropout 0, batch {RING_TRAIN_BATCH}): one _update vs the "
        f"full model's: loss {loss['ring']:.6f} vs {loss['full']:.6f}, gradients worst "
        f"{grad_err:.3e} (limit {GRAD_TOL}); launches {_launch_report(launches['ring'], expected)}"
        f" (full model {launches['full']}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"the ring model's training step on {n} rank(s) disagrees with the full model's or "
             f"launched {launches['ring']}")
    return dict(loss=loss, grad_err=grad_err, launches=launches["ring"],
                full_launches=launches["full"])


def _tp_vs_replicated(torch, wrappers, device, log):
    """The flagship (kernels on, dropout 0.05) made tensor-parallel over a
    ``model`` axis of every rank (``parallel/tensor.py``; at world 1 every
    shard is whole) against the replicated model with the same weights:
    one eval batch (``MAIN_TOL``), then one ``_update`` on the same batch and
    generator (max pooling routed as the TP step's): loss, each shard's
    gradient against its rows of the replicated one and every replicated
    parameter's (``GRAD_TOL``), the replicated gradients equal on every
    rank, 13 + 13 bd launches."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import make_batch
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.parallel.mesh import make_mesh
    from channelestimationtransformer_torch.parallel.tensor import (
        replicated_grads_equal,
        sharded_names,
        tensor_parallel,
    )
    from channelestimationtransformer_torch.train.trainer import _update, create_train_state

    n, r = dist.get_world_size(), dist.get_rank()
    cfg = InformerConfig(use_pallas=True)
    tc = TrainConfig(batch_size=256, lr=1e-4)
    models = {"tp": tensor_parallel(build_informer(cfg, device=device, seed=0),
                                    make_mesh(data=1, model=n)),
              "replicated": build_informer(cfg, device=device, seed=0)}
    ds = _card_data(torch, cfg.seq_len, cfg.pred_len, samples=4096)
    batch = make_batch(ds, 256, cfg.label_len,
                       generator=torch.Generator(device=device).manual_seed(8))
    with torch.no_grad():
        outs = {path: m.eval()(batch[0], batch[1]) for path, m in models.items()}
    fwd_text, fwd_ok, fwd_err = _close(torch, outs["tp"], outs["replicated"], "float32")
    states = {path: create_train_state(m, tc) for path, m in models.items()}
    routing, metrics, launches = [], {}, {}
    for path, state in states.items():
        torch.cuda.synchronize()
        _zero_counts(wrappers)
        with _maxpool_routing(torch, routing, replay=path != "tp") as flips:
            metrics[path] = _update(state, *batch,
                                    torch.Generator(device=device).manual_seed(9))
        torch.cuda.synchronize()
        launches[path] = _counts(wrappers)
    sharded = sharded_names(models["tp"])
    want = _grads(models["replicated"])
    got = _grads(models["tp"])
    for name in sharded:
        rows = want[name].shape[0] // n
        want[name] = want[name][r * rows:(r + 1) * rows]
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    grad_err = max(_grad_errors(got, want, floor).values())
    equal = replicated_grads_equal(models["tp"])
    loss = {path: m["loss"].item() for path, m in metrics.items()}
    expected = dict(bd_fwd=13, bd_bwd=13, mha=0)
    ok = (fwd_ok and equal and grad_err <= GRAD_TOL and launches["tp"] == expected
          and abs(loss["tp"] - loss["replicated"]) <= MAIN_TOL[0] * abs(loss["replicated"]))
    log(f"parallel tensor-parallel (world {n}, model axis {n}: {len(sharded)} weights "
        f"sharded, {sum(p.numel() for p in models['tp'].parameters())} of "
        f"{sum(p.numel() for p in models['replicated'].parameters())} parameters on a rank; "
        f"flagship, kernels on, dropout 0.05) vs the replicated model: eval batch {fwd_text}; "
        f"one _update: loss {loss['tp']:.6f} vs {loss['replicated']:.6f}, gradients (shards "
        f"against their rows) worst {grad_err:.3e} (limit {GRAD_TOL}; max pooling routed as "
        f"the TP step's, {sum(flips)} windows differ from the replicated model's own argmax), "
        f"replicated gradients equal on every rank {equal}; launches "
        f"{_launch_report(launches['tp'], expected)} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"the tensor-parallel forward or step on {n} rank(s) disagrees with the replicated "
             f"model's or launched {launches['tp']}")
    return dict(max_abs=fwd_err, loss=loss, grad_err=grad_err, sharded=len(sharded),
                launches=launches["tp"])


def parallel_rank(out_path):
    """One rank of :func:`phase_parallel`'s group: joins it (NCCL, one card a
    rank), runs the DP checks in f32 and bf16 (:func:`_dp_world1` at world
    1, :func:`_dp_ranks` across ranks) and the ring (:func:`_ring_vs_full`),
    and rank 0 writes the results to ``out_path``."""
    import torch
    import torch.distributed as dist

    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import mha_attention as mha
    from channelestimationtransformer_torch.parallel.launch import join_local

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    device = join_local()
    world, rank = dist.get_world_size(), dist.get_rank()
    wrappers = dict(bd_fwd=ops.bd_attention_fwd, bd_bwd=ops.bd_attention_bwd,
                    mha=mha.mha_attention_fwd)

    def log(*args, **kwargs):
        if rank == 0:
            print(*args, **kwargs)

    result = dict(world=world, backend=dist.get_backend(), card=torch.cuda.get_device_name())
    x = torch.zeros(1, device=device)
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    result["all_reduce_us"] = (host / 200 * 1e6, (time.perf_counter() - t0) / 200 * 1e6)
    log(f"parallel world {world}: a 4-byte NCCL all-reduce takes {result['all_reduce_us'][0]:.1f} "
        f"us of host time ({result['all_reduce_us'][1]:.1f} us to the device's end; 200 calls)",
        flush=True)
    for dtype in ("float32", "bfloat16"):
        result[dtype] = (_dp_world1 if world == 1 else _dp_ranks)(torch, wrappers, device, dtype,
                                                                   log)
    result["ring"] = _ring_vs_full(torch, wrappers, device, log)
    result["ring_train"] = _ring_train(torch, wrappers, device, log)
    result["tensor_parallel"] = _tp_vs_replicated(torch, wrappers, device, log)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(result, indent=1))
    dist.barrier()
    dist.destroy_process_group()


def _per_path(rows, key, weight):
    """Sum of ``key`` weighted by each row's count on the path (``weight``)."""
    return sum(r[key] * r[weight] for r in rows if r[weight])


def _kernel_entry(name, replaces, launches, rows, weight, per, source=None):
    tpu = "channelestimationtransformer_tpu/ops/pallas/"
    return {
        "name": name,
        "route": "cuda",
        "source": f"channelestimationtransformer_torch/ops/cuda/csrc/{source or name}.cu",
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

    if "--parallel-rank" in argv:
        return parallel_rank(argv[argv.index("--parallel-rank") + 1])
    if "--gloo-probe-rank" in argv:
        return gloo_probe_rank()
    if "--two-axis-rank" in argv:
        i = argv.index("--two-axis-rank")
        return two_axis_rank(argv[i + 1], argv[i + 2])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build
    from channelestimationtransformer_torch.ops.cuda import bd_attention as ops
    from channelestimationtransformer_torch.ops.cuda import circular_conv as cc
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
    # bf16 and fp16 GEMMs accumulate in f32 throughout, as the JAX package's dots do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    print(f"device: {card} | torch {torch.__version__}, CUDA {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} "
          f"matmul.allow_fp16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction}", flush=True)

    t0 = time.perf_counter()
    conv_only = "--conv" in argv
    libs = (cc.LIB,) if conv_only else (ops.FWD_LIB, ops.BWD_LIB, mha.LIB, quant.FIXED_LIB,
                                         quant.CODEWORD_LIB, cc.LIB)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        builds = list(pool.map(_build.build, libs))
    build_s = time.perf_counter() - t0
    build_info = {}
    for name, (lib, log) in zip(libs, builds):
        (OUT / f"ptxas_{name}.txt").write_text(log)
        hmma = _sass_hmma(lib)
        instances = _build_instances(log, hmma)
        info = build_info[name] = dict(
            **_ptxas_summary(log), instances=instances,
            hmma=None if hmma is None else sum(c[k] for c in hmma.values() for k in MMA_KINDS),
            hgmma=None if hmma is None else sum(c["hgmma"] for c in hmma.values()))
        print(f"build: {lib.name} ({build_s:.2f} s for all {len(libs)}): "
              f"{info['kernels']} kernels, registers {info['registers_min']}-"
              f"{info['registers_max']}, spill stores {info['spill_stores']} bytes, spill "
              f"loads {info['spill_loads']} bytes, static shared memory up to "
              f"{info['smem_max']} bytes (ptxas -v); SASS: {info['hmma']} tensor-core MMAs "
              f"(HMMA and HGMMA), {info['hgmma']} of them HGMMA", flush=True)
        if name in TENSOR_CORE_LIBS:
            for dtype_name in MMA_KIND_OF:
                rows = [r for r in instances if r["dtype"] == dtype_name]
                regs = [r["registers"] for r in rows]
                hm = {k: (None if hmma is None else sum(r[f"hmma_{k}"] for r in rows))
                      for k in MMA_KINDS}
                hg = None if hmma is None else sum(r["hgmma"] for r in rows)
                print(f"build: {name} {dtype_name} instances: {len(rows)}, registers "
                      f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
                      f"{sum(r['spill_bytes'] for r in rows)}; MMA bf16 {hm['bf16']}, TF32 "
                      f"{hm['tf32']}, f16 {hm['f16']}, other {hm['other']} (HGMMA {hg})",
                      flush=True)
                for r in rows:
                    if "wgmma" in r["label"]:
                        print(f"build: {name} {r['label']}: {r['registers']} registers, "
                              f"{r['spill_bytes']} spill bytes, HGMMA {r['hgmma']}, bf16 "
                              f"{r['hmma_bf16']}, TF32 {r['hmma_tf32']}, f16 "
                              f"{r['hmma_f16']}", flush=True)
            faults = _mma_faults(instances)
            if faults:
                fail(f"{name}: instances issuing MMAs of another dtype: {faults}")
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

    if conv_only:
        conv = phase_circular_conv(torch, F)
        (OUT / "chip_smoke_conv.json").write_text(json.dumps(dict(
            card=card, build_s=build_s, build_info=build_info, conv=conv), indent=1))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                  "kind": torch.cuda.get_device_name(0),
                                                  "count": torch.cuda.device_count()}}),
              flush=True)
        return None

    profile = "--profile" in argv
    wrappers = dict(bd_fwd=ops.bd_attention_fwd, bd_bwd=ops.bd_attention_bwd,
                    mha=mha.mha_attention_fwd, fixed=quant.fused_fixed_point_quantize,
                    codeword=quant.fused_nearest_codeword, conv=cc.circular_conv1d_fwd,
                    conv_dgrad=cc.circular_conv1d_dgrad, conv_wgrad=cc.circular_conv1d_wgrad)
    eval_rows = phase_kernel(torch, F, ops.bd_attention, ops.bd_attention_reference,
                             [s + (B, H, E, E) for s in SHAPES])
    mha_rows = phase_kernel(torch, F, mha.mha_attention, mha.mha_attention_reference,
                            [s + (XL_B, XL_H, XL_E, XL_E) for s in XL_SHAPES]
                            + MHA_EXTRA_SHAPES, prefix="mha kernel", seed=2, mha=mha)
    fixed_rows = phase_fixed_kernel(torch, quant, ops.draw_seed)
    grouped_rows = phase_fixed_grouped(torch, quant, ops.draw_seed)
    codeword_rows = phase_codeword_kernel(torch, quant, codebooks)
    lsq_rows = phase_lsq_codeword(torch, quant, lsq, codebooks)
    fwd_rows, bwd_rows = phase_kernel_train(torch, F, ops)
    conv = phase_circular_conv(torch, F)
    # The scale demo's and the int8 A/B's attention shapes beyond the lists above (E 32
    # and 64; L 256 at E 64 on mha), checked in eval and in training.
    scale_bd, scale_mha = scale_kernel_shapes()
    scale_rows = dict(
        eval=phase_kernel(torch, F, ops.bd_attention, ops.bd_attention_reference, scale_bd,
                          prefix="scale kernel", seed=3, timed=False),
        mha=phase_kernel(torch, F, mha.mha_attention, mha.mha_attention_reference, scale_mha,
                         prefix="scale mha kernel", seed=4, mha=mha))
    scale_rows["train_fwd"], scale_rows["train_bwd"] = phase_kernel_train(
        torch, F, ops, [s[:-1] for s in scale_bd], prefix="scale train", timed=False)
    print(f"scale kernels: {len(scale_bd)} bd shapes (eval, train forward and backward) and "
          f"{len(scale_mha)} mha shapes, {', '.join(KERNEL_DTYPES)}, each against its plain "
          f"version", flush=True)
    eval_path = phase_eval_path(torch, wrappers, card, profile)
    xl_cfg = InformerConfig(d_model=1024, d_ff=4096, seq_len=256, use_pallas=True)
    xl_eval_path = phase_eval_path(torch, wrappers, card, profile, name="xl eval path",
                                   cfg=xl_cfg, samples=4096, slots=xl_cfg.seq_len + 10,
                                   batch=64, expected={"mha": 13 * 8},
                                   expected_routes=mha_routes(xl_cfg, torch.float32, 8))
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

    # bf16 activations (bench.py's config, and scale_demo.py's default dtype at xl).
    bf16_eval_path = phase_eval_path(torch, wrappers, card, profile, name="bf16 eval path",
                                     cfg=InformerConfig(use_pallas=True, dtype="bfloat16"))
    bf16_xl_eval_path = phase_eval_path(
        torch, wrappers, card, profile, name="bf16 xl eval path",
        cfg=dataclasses.replace(xl_cfg, dtype="bfloat16"), samples=4096,
        slots=xl_cfg.seq_len + 10, batch=64, expected={"mha": 13 * 8},
        expected_routes=mha_routes(xl_cfg, torch.bfloat16, 8))  # wgmma 40, mma 64
    bf16_lsq_batch = phase_one_batch(
        torch, wrappers, "bf16 lsq-fibbinary eval batch",
        dataclasses.replace(lsq_cfg, dtype="bfloat16"), {"bd_fwd": 13, "codeword": 72})
    bf16_train_path = phase_train_path(torch, wrappers, card, profile,
                                       cfg=InformerConfig(use_pallas=True, dtype="bfloat16"),
                                       name="bf16 train")

    # float16 activations: the same paths (the xl eval path at F16_MHA_TOL).
    f16_eval_path = phase_eval_path(torch, wrappers, card, profile, name="f16 eval path",
                                    cfg=InformerConfig(use_pallas=True, dtype="float16"))
    f16_xl_eval_path = phase_eval_path(
        torch, wrappers, card, profile, name="f16 xl eval path",
        cfg=dataclasses.replace(xl_cfg, dtype="float16"), samples=4096,
        slots=xl_cfg.seq_len + 10, batch=64, expected={"mha": 13 * 8},
        expected_routes=mha_routes(xl_cfg, torch.float16, 8), tol=F16_MHA_TOL)  # wgmma 40, mma 64
    f16_lsq_batch = phase_one_batch(
        torch, wrappers, "f16 lsq-fibbinary eval batch",
        dataclasses.replace(lsq_cfg, dtype="float16"), {"bd_fwd": 13, "codeword": 72})
    f16_train_path = phase_train_path(torch, wrappers, card, profile,
                                      cfg=InformerConfig(use_pallas=True, dtype="float16"),
                                      name="f16 train")
    # The bd kernels' instances side by side, a training step each.
    for kernel, rows, key in ((ops.FWD_LIB, fwd_rows, "launches_fwd"),
                              (ops.BWD_LIB, bwd_rows, "launches_bwd")):
        for dtype_name, path in (("float32", train_path), ("bfloat16", bf16_train_path),
                                 ("float16", f16_train_path)):
            rs = [r for r in rows if r["dtype"] == dtype_name]
            print(f"{kernel} {dtype_name}, one training step ({sum(r['calls_per_step'] for r in rs)}"
                  f" calls): {_per_path(rs, 'ms', 'calls_per_step') * 1e3:.1f} us by graph "
                  f"replay, eager {_per_path(rs, 'eager_ms', 'calls_per_step') * 1e3:.1f} us, "
                  f"bound {_per_path(rs, 'bound_ms', 'calls_per_step') * 1e3:.1f} us, "
                  f"{path[key]} launches in {TRAIN_STEPS} steps; "
                  + "; ".join(f"{r['shape']}: {r['occupancy']['registers']} registers, "
                              f"{r['occupancy']['blocks_per_sm']} blocks an SM" for r in rs),
                  flush=True)

    # The channel generator and the training driver (cli.train_informer).
    datagen = phase_datagen(torch, card)
    cli = phase_cli(torch, wrappers)

    # ProbSparse attention (the decoder's cross-attention alone on the bd
    # kernels), fuse_qkv, and LSQ training from the cli phase's checkpoint.
    def full_flagship(_):
        return {"full-kernel": build_informer(InformerConfig(use_pallas=True), device="cuda",
                                              seed=0)}
    prob_cfg = InformerConfig(use_pallas=True, attn="prob")
    prob_eval_path = phase_eval_path(torch, wrappers, card, profile, name="prob eval path",
                                     cfg=prob_cfg, expected={"bd_fwd": 3 * 8},
                                     beside=full_flagship)
    prob_train_path = phase_train_path(torch, wrappers, card, profile, cfg=prob_cfg,
                                       name="prob train", per_step=dict(bd_fwd=3, bd_bwd=3),
                                       beside=full_flagship, reference=A100_PROB)
    fused_cfg = InformerConfig(use_pallas=True, fuse_qkv=True)
    fused_eval_path = phase_eval_path(torch, wrappers, card, profile, name="fused eval path",
                                      cfg=fused_cfg,
                                      beside=lambda m: {"unfused": _unfused_twin(m)})
    fused_train_path = phase_train_path(torch, wrappers, card, profile, cfg=fused_cfg,
                                        name="fused train",
                                        beside=lambda m: {"unfused": _unfused_twin(m)})
    fused_vs_unfused = phase_fused_vs_unfused(torch, card)
    lsq_train = phase_lsq_train(
        torch, wrappers, lsq,
        OUT / "cli" / f"tmodel_{cli['result']['name']}_{CLI_EPOCHS}.pt")
    lsq_train_path = phase_train_path(torch, wrappers, card, profile, cfg=lsq_cfg,
                                      name="lsq-fibbinary train",
                                      per_step=dict(bd_fwd=13, bd_bwd=13, codeword=2 * 72))

    # The quantization study: QAT and pruning steps, then the three drivers
    # from the cli phase's checkpoint.
    qat_prune = phase_qat_prune(torch, wrappers, card)
    drivers = phase_study_drivers(
        torch, wrappers, OUT / "cli" / f"tmodel_{cli['result']['name']}_{CLI_EPOCHS}.pt")

    # int8 serving, streaming, the baselines, and their three drivers
    # (the first two from the cli phase's checkpoint).
    from channelestimationtransformer_torch.ops.quant import serving

    gemms = dict(int8=serving.int8_matmul, bf16_f32=serving.bf16_matmul_f32)
    int8_path = phase_int8_path(torch, wrappers, gemms, card)
    streaming = phase_streaming(torch, wrappers, card)
    baselines = phase_baselines(torch, wrappers, card)
    cmp_cfg = InformerConfig(seq_len=25, label_len=10, pred_len=5, use_pallas=True)
    cmp_batch = phase_one_batch(torch, wrappers, "comparison informer eval batch", cmp_cfg,
                                {"bd_fwd": 13})
    cmp_train_path = phase_train_path(torch, wrappers, card, profile, cfg=cmp_cfg,
                                      name="comparison informer train")
    serving_drivers = phase_serving_drivers(
        torch, wrappers, gemms, OUT / "cli" / f"tmodel_{cli['result']['name']}_{CLI_EPOCHS}.pt")

    # The link simulation and its drivers (from the cli phase's checkpoint),
    # then the scale demo and its int8 A/B.
    link = phase_link(torch, card)
    e2e = phase_e2e_drivers(
        torch, wrappers, card, OUT / "cli" / f"tmodel_{cli['result']['name']}_{CLI_EPOCHS}.pt")
    scale = phase_scale_demo(torch, wrappers, card)
    int8_ab = phase_int8_scale_ab(torch, wrappers, gemms, card)

    # The utilities and the analysis drivers (from the cli phase's checkpoint).
    analysis = phase_analysis(torch, wrappers, card, OUT / "cli", cli["result"]["name"],
                              cli.pop("log"))

    # The calibration and profiling drivers, cut short.
    driver_phase = phase_drivers(torch, wrappers, card)

    # Data parallelism over NCCL, the ring (eval and training), tensor
    # parallelism and the two-axis mesh, in subprocesses of this script.
    parallel = phase_parallel(torch, card)
    two_axis = parallel.pop("two_axis")

    f32 = lambda rows: [r for r in rows if r["dtype"] == "float32"]  # noqa: E731
    bf16 = lambda rows: [r for r in rows if r["dtype"] == "bfloat16"]  # noqa: E731
    f16 = lambda rows: [r for r in rows if r["dtype"] == "float16"]  # noqa: E731
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
    # Each attention kernel's bf16 and f16 instances on their paths, as the f32 keys.
    bf16_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "per")
    for dtype_name, pick, train, xl in (("bfloat16", bf16, bf16_train_path, bf16_xl_eval_path),
                                        ("float16", f16, f16_train_path, f16_xl_eval_path)):
        tag = "bf16" if dtype_name == "bfloat16" else "f16"
        for kernel, launches, rows, weight, per in (
                (kernels[0], train["launches_fwd"], fwd_rows, "calls_per_step",
                 f"one {tag} training step: the 13 calls at their flagship shapes (dropout "
                 f"0.05)"),
                (kernels[1], train["launches_bwd"], bwd_rows, "calls_per_step",
                 f"one {tag} training step: the 13 calls at their flagship shapes (dropout "
                 f"0.05)"),
                (kernels[2], xl["launches"]["mha"], mha_rows, "calls_per_batch",
                 f"one {tag} xl eval batch: the 13 calls at their xl shapes (B 64, H 8, "
                 f"E 128)")):
            entry = _kernel_entry(kernel["name"], [], launches, pick(rows), weight, per)
            kernel[dtype_name] = {k: entry[k] for k in bf16_keys}
    # The mha launches by route, and the wgmma route (bf16, Lq > 32, E and D 64 or
    # 128) as an entry of its own: its 5 calls of the bf16 xl batch.
    kernels[2].update(launches_by_route=xl_eval_path["launches_by_route"])
    kernels[2]["bfloat16"].update(launches_by_route=bf16_xl_eval_path["launches_by_route"])
    kernels[2]["float16"].update(launches_by_route=f16_xl_eval_path["launches_by_route"])
    wgmma_rows = [r for r in bf16(mha_rows) if r["route"] == "wgmma"]
    kernels.append(_kernel_entry(
        "mha_attention_fwd[wgmma]", ["attention.py:70"],
        bf16_xl_eval_path["launches_by_route"]["wgmma"], wgmma_rows, "calls_per_batch",
        "one bf16 xl eval batch: the wgmma route's calls (L 256, 128 and 64; B 64, H 8, "
        "E 128)", source="mha_attention_fwd"))
    kernels[5].update(rows={r["shape"]: dict(ms=r["ms"], bound_ms=r["bound_ms"],
                                             library_ms=r["library_ms"],
                                             occupancy=r["occupancy"]) for r in wgmma_rows})
    f16_wgmma_rows = [r for r in f16(mha_rows) if r["route"] == "wgmma"]
    entry = _kernel_entry("mha_attention_fwd[wgmma]", [],
                          f16_xl_eval_path["launches_by_route"]["wgmma"], f16_wgmma_rows,
                          "calls_per_batch", "one f16 xl eval batch: the wgmma route's calls")
    kernels[5]["float16"] = {k: entry[k] for k in bf16_keys}
    kernels[5]["float16"].update(rows={r["shape"]: dict(ms=r["ms"], bound_ms=r["bound_ms"],
                                                        library_ms=r["library_ms"],
                                                        plain_ms=r["plain_ms"])
                                       for r in f16_wgmma_rows})
    for dtype_name, pick, path in (("bfloat16", bf16, bf16_eval_path),
                                   ("float16", f16, f16_eval_path)):
        kernels[0][dtype_name].update(
            eval_launches=path["launches"]["bd_fwd"],
            eval_ms=_per_path(pick(eval_rows), "ms", "calls_per_batch"),
            eval_bound_ms=_per_path(pick(eval_rows), "bound_ms", "calls_per_batch"),
            eval_library_ms=_per_path(pick(eval_rows), "library_ms", "calls_per_batch"))
    # The slice-10 paths' launches, beside each kernel's main path's.
    for kernel, key in ((kernels[0], "bd_fwd"), (kernels[1], "bd_bwd")):
        kernel.update(prob_train_launches=prob_train_path["launches"][key],
                      fused_train_launches=fused_train_path["launches"][key],
                      lsq_train_launches=lsq_train_path["launches"][key],
                      lsq_driver_launches=lsq_train["launches"][key])
    kernels[0].update(prob_eval_launches=prob_eval_path["launches"]["bd_fwd"],
                      fused_eval_launches=fused_eval_path["launches"]["bd_fwd"])
    kernels[4].update(lsq_train_launches=lsq_train_path["launches"]["codeword"],
                      lsq_driver_launches=lsq_train["launches"]["codeword"],
                      lsq_driver_lsq_mode_launches=lsq_train["lsq_mode_launches"])
    # The slice-11 paths' launches: 8-step QAT and prune chunks and the drivers.
    for kernel, key in ((kernels[0], "bd_fwd"), (kernels[1], "bd_bwd")):
        kernel.update(qat_train_launches=qat_prune["qat fixed"]["launches"][key],
                      prune_train_launches=qat_prune["prune"]["launches"][key],
                      qat_driver_launches=drivers["qat_incremental"]["launches"][key],
                      prune_driver_launches=drivers["prune"]["launches"][key])
    kernels[0].update(ptq_driver_launches=drivers["ptq_sweep"]["launches"]["bd_fwd"])
    kernels[3].update(qat_train_launches=qat_prune["qat fixed"]["launches"]["fixed"],
                      ptq_driver_launches=drivers["ptq_sweep"]["launches"]["fixed"])
    kernels[4].update(qat_train_launches=qat_prune["qat fibbinary"]["launches"]["codeword"],
                      qat_driver_launches=drivers["qat_incremental"]["launches"]["codeword"])
    # The int8, streaming and driver paths' launches.
    driver_launches = {name: run["launches"] for name, run in serving_drivers.items()}
    kernels[0].update(int8_eval_launches=int8_path["w8a8"]["launches"]["bd_fwd"],
                      int8_wo_eval_launches=int8_path["weight_only"]["launches"]["bd_fwd"],
                      streaming_launches=streaming["launches"]["bd_fwd"],
                      int8_driver_launches=driver_launches["int8_serving"]["bd_fwd"],
                      streaming_driver_launches=driver_launches["train_streaming"]["bd_fwd"],
                      comparison_driver_launches=driver_launches["comparison"]["bd_fwd"])
    kernels[1].update(comparison_driver_launches=driver_launches["comparison"]["bd_bwd"],
                      comparison_train_launches=cmp_train_path["launches"]["bd_bwd"])
    kernels[0].update(comparison_train_launches=cmp_train_path["launches"]["bd_fwd"],
                      comparison_eval_launches=cmp_batch["launches"]["bd_fwd"])
    # The e2e drivers', the scale demo's and the int8 A/B's launches.
    kernels[0].update(
        e2e_driver_launches=sum(run["launches"]["bd_fwd"] for run in e2e.values()),
        scale_demo_launches=sum(run["launches"]["bd_fwd"] for run in scale.values()),
        int8_scale_ab_launches=sum(run["launches"]["bd_fwd"] for run in int8_ab.values()))
    kernels[1].update(scale_demo_launches=sum(run["launches"]["bd_bwd"] for run in scale.values()))
    kernels[2].update(int8_scale_ab_launches=sum(run["launches"]["mha"]
                                                 for run in int8_ab.values()))
    # The analysis phase's: the traced eval chunk, the timing sweep's two axes
    # (eager warm-ups and captured forwards), eval_parity_ci's kernel path.
    kernels[0].update(trace_launches=analysis["trace"]["launches"]["bd_fwd"],
                      timing_analysis_launches=analysis["timing_analysis"]["launches"]["bd_fwd"],
                      eval_parity_ci_launches=analysis["eval_parity_ci"]["launches"]["bd_fwd"])
    # The parallel phase's: train_chunk_dp (8 steps) at each world size, rank 0's
    # count, and the ring Informer's batch (its decoder on mha).
    for world, run in parallel.items():
        for kernel, key in ((kernels[0], "bd_fwd"), (kernels[1], "bd_bwd")):
            kernel[f"dp_train_launches_world{world}"] = run["float32"]["launches"][key]
            kernel["bfloat16"][f"dp_train_launches_world{world}"] = (
                run["bfloat16"]["launches"][key])
        kernels[2][f"ring_eval_launches_world{world}"] = run["ring"]["launches"]["mha"]
        for kernel, key in ((kernels[0], "bd_fwd"), (kernels[1], "bd_bwd")):
            kernel[f"ring_train_launches_world{world}"] = run["ring_train"]["launches"][key]
            kernel[f"tp_train_launches_world{world}"] = run["tensor_parallel"]["launches"][key]
    # The two-axis phase's, rank 0's count of one step (data 2 x model 2),
    # where its 4 ranks could run (phase_two_axis fails a run without them).
    for kernel, key in ((kernels[0], "bd_fwd"), (kernels[1], "bd_bwd"), (kernels[4], "codeword")):
        for step in ("step", "lsq_step"):
            kernel[f"two_axis_{step}_launches"] = (two_axis[step]["launches"][key]
                                                   if two_axis["four_ranks"] else None)
    # The drivers phase's, summed over the eight drivers.
    for kernel, key in zip(kernels, ("bd_fwd", "bd_bwd", "mha", "fixed", "codeword")):
        kernel["drivers16_launches"] = sum(run["launches"][key]
                                           for name, run in driver_phase.items()
                                           if name != "seconds")
    # The circular convolution's kernels: times of one training step at batch
    # 1024 (phase_circular_conv); launches of the train path's chunk and the
    # eval path's, counted there.
    for key, count, fn, replaces in (
            ("fwd", "conv", "shift_kernel<false>", "forward"),
            ("dgrad", "conv_dgrad", "shift_kernel<true>", "data gradient"),
            ("wgrad", "conv_wgrad", "wgrad_kernel, wgrad_reduce_kernel", "weight gradient")):
        kernels.append(dict(name=f"circular_conv1d[{key}]", route="cuda", kernel=fn,
                            source=f"channelestimationtransformer_torch/ops/cuda/csrc/{cc.LIB}.cu",
                            replaces=f"none (cuDNN's {replaces} of the circular k=3 conv)",
                            launches=train_path["launches"][count],
                            per="one flagship training step at batch 1024",
                            **conv["per_step"][key]))
    kernels[-3].update(eval_launches=eval_path["launches"]["conv"])
    kernels[-1].update(reductions=train_path["launches"]["conv_reduce"])
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, build_info=build_info, kernel_rows=eval_rows,
        mha_kernel_rows=mha_rows, fixed_rows=fixed_rows, fixed_grouped_rows=grouped_rows,
        codeword_rows=codeword_rows,
        lsq_codeword_rows=lsq_rows, train_fwd_rows=fwd_rows,
        train_bwd_rows=bwd_rows, scale_kernel_rows=scale_rows, eval_path=eval_path, xl_eval_path=xl_eval_path,
        ptq_path=ptq_path, lsq_path=lsq_path, train_path=train_path,
        bf16_eval_path=bf16_eval_path, bf16_xl_eval_path=bf16_xl_eval_path,
        bf16_lsq_batch=bf16_lsq_batch, bf16_train_path=bf16_train_path,
        f16_eval_path=f16_eval_path, f16_xl_eval_path=f16_xl_eval_path,
        f16_lsq_batch=f16_lsq_batch, f16_train_path=f16_train_path, datagen=datagen,
        cli=cli, prob_eval_path=prob_eval_path, prob_train_path=prob_train_path,
        fused_eval_path=fused_eval_path, fused_train_path=fused_train_path,
        fused_vs_unfused=fused_vs_unfused, lsq_train=lsq_train, lsq_train_path=lsq_train_path,
        qat_prune=qat_prune, drivers=drivers, int8_path=int8_path, streaming=streaming,
        baselines=baselines, comparison_informer_batch=cmp_batch,
        comparison_informer_train_path=cmp_train_path, serving_drivers=serving_drivers,
        link=link, e2e_drivers=e2e, scale_demo=scale, int8_scale_ab=int8_ab, analysis=analysis,
        drivers16=driver_phase, parallel=parallel, two_axis=two_axis, circular_conv=conv,
        kernels=kernels),
        indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
