"""Where the tensor-core attention kernels spend their time, on one NVIDIA card.

    python3 attention_ablation.py [--baseline NAME=CSRC_DIR ...] [--only KERNEL ...]

Builds each of ``csrc/mha_attention_fwd.cu``, ``csrc/bd_attention_fwd.cu``
and ``csrc/bd_attention_bwd.cu`` as it is and with one part cut out, and
times every build on the path's calls (random inputs; the bd kernels in f32
and bf16, mha in f32 on its mma route and in bf16 on both routes): the
``xl`` encoder's L 256 and L 128 mha calls (B 64, H 8, E 128; bf16 also
L 64), the flagship's
forward calls with dropout 0.05 and the lse (B 256, H 8, E 16: the encoder's
L 90, 45, 23 and 12, the decoder's causal 15 and its 15 x 24 cross call)
and its L 90 and L 45 backward calls. A cut build computes wrong results;
only its time is read. The difference to the full build bounds what the
cut part costs where it does not overlap the rest:

- mha ``no_mma``: no Q K^T and no P V (loads, softmax and stores remain);
- mha ``no_prefetch``: the next K/V tile is not copied (the first is);
- mha ``wgmma_no_mma``: the wgmma route without its products (the TMA
  loads, softmax and stores remain);
- mha ``wgmma_no_prefetch``: the wgmma route's K/V ring holds one stage, so
  no tile loads while the one before it is in use;
- mha ``wgmma_one_consumer``: one consumer warpgroup (64 query rows, key
  tiles of 64, two blocks an SM) in place of two at every length;
- mha ``wgmma_bk64_4_stages``: not a cut: key tiles of 64 with two
  consumers in a ring of four stages (the shared memory of two of 128);
- mha ``wgmma_one_q_buffer``: not a cut: one Q buffer with two consumers,
  so the next item's Q loads only after this item's last Q K^T;
- fwd ``no_mma``: no S and no P V products (both dtypes);
- fwd ``no_dropout_bits``: no Philox calls (every key kept);
- fwd ``three_blocks``: not a cut: registers held for three blocks an SM
  (spills where the scores need more), for occupancy against spills;
- bwd ``no_row_mma``: no S, dP and dQ products in the row phase;
- bwd ``no_key_phase``: no dK and dV products;
- bwd ``no_dropout_bits``: no Philox calls (every key dropped);
- fixed ``ballot_search``: not a cut: each warp finds its block's tensor by
  a ballot over four lane-indexed loads of the table instead of the binary
  search;
- fixed ``key_first``: not a cut: the seed is read before the search;
- fixed ``small_table``: a table of 2 entries (a 32-byte parameter block
  beside 3.7 KB; refuses the 72-tensor launch);
- fixed ``t_zero``: counter word 2 is 0 for every tensor;
- fixed ``vec_only``: the float4 path only;
- fixed ``no_philox``: no Philox calls (u = 0);
- fixed ``grid_y``: not a cut: a two-dimensional grid, the tensor's index
  in ``blockIdx.y`` (no search; the widest tensor's blocks for every one).

It also times ``csrc/nearest_codeword.cu``, snap and LSQ modes, at the
flagship's two layer sizes (16,384 and 8,192 elements, the 67-entry
codebook), and ``csrc/fixed_point_quantize.cu`` (the ``fixed`` mode) at the
flagship's 72 PTQ tensors (wl 8, fl 4, nearest and stochastic): one
grouped launch against 72 launches of a group of one, and against 72
launches of a baseline's single-tensor entry (``fixed_point_quantize``, PR
6's C interface), the grouped launch over 72 views of one buffer (memory
layout), and one 2^20-element tensor each way, each as device time
and as host time per quantization through ctypes alone; then,
for this checkout, host time through the Python wrappers (grouped, and 72
single-tensor calls) and of the two ways to allocate the outputs (one flat
buffer cut into views, 72 ``empty_like``). The device times say what the
grouping bought on the card, the host times what it bought in the wrapper.

``--only KERNEL`` (repeatable) builds and times only those kernels.

``--baseline NAME=CSRC_DIR`` (repeatable) also builds every kernel from the
``.cu`` and ``.cuh`` files of another checkout's ``csrc`` directory (its C
interfaces must be this one's, or PR 6's single-tensor fixed-point entry)
and times it as the variant NAME, for
comparing two versions of the code in one call; a mode the baseline lacks
is skipped.

Times are CUDA-graph replays of 20 launches, median of 5, after a warm-up.
Builds go to ``channelestimationtransformer_torch/build/ablation/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

MHA = "mha_attention_fwd"
FWD = "bd_attention_fwd"
BWD = "bd_attention_bwd"
CODEWORD = "nearest_codeword"
LSQ = "nearest_codeword_lsq"  # the LSQ mode's entry in the codeword library
FIXED = "fixed_point_quantize"
GROUPED = "fixed_point_quantize_grouped"  # this checkout's entry in the fixed-point library
SINGLE = "fixed_point_quantize"  # the single-tensor entry of earlier checkouts (PR 6)
FLAGSHIP_TENSORS = [(128, 128)] * 52 + [(128, 64)] * 20  # the 72 PTQ weights
# (kernel, variant) -> (statement in the source, its replacement)
CUTS = {
    (MHA, "no_mma"): [("scores<NT, P::q, P::k, W>(s, sq + 16 * wi * P::q, kt, g, t);", ""),
                      ("pv<NT, NO, P::v>(acc, s, vt, g, t, lane);", "")],
    (MHA, "no_prefetch"): [("if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);",
                            "")],
    (MHA, "wgmma_no_mma"): [("  wgmma_ss<T, BK>(s,", "  if (false) wgmma_ss<T, BK>(s,"),
                            ("  wgmma_rs<T, WD>(o, p[kk],", "  if (false) wgmma_rs<T, WD>(o, p[kk],")],
    (MHA, "wgmma_no_prefetch"): [("constexpr int kWgStages = 2;", "constexpr int kWgStages = 1;")],
    (MHA, "wgmma_one_consumer"): [("const bool two = a.Lq > 64;", "const bool two = false;")],
    (MHA, "wgmma_bk64_4_stages"): [("BK = NC == 2 ? 128 : 64;", "BK = 64;"),
                                   ("kWgStages = 2;", "kWgStages = 4;")],
    (MHA, "wgmma_one_q_buffer"): [("q_buffers = NC == 2 ? 2 : 1;", "q_buffers = 1;")],
    (FWD, "no_mma"): [("mma_split_tf32(s[n], ah, al, bh, bl);", ""),
                      ("mma_split_tf32(acc[n], ah, al, bh, bl);", ""),
                      ("mma_b16<H>(s[n], a, b);", ""),
                      ("mma_operand<H>(acc[n], hi, lo, b0);\n      "
                       "mma_operand<H>(acc[n + 1], hi, lo, b1);", "")],
    (FWD, "no_dropout_bits"): [("const bool dropout = seed != nullptr;",
                                "const bool dropout = false;")],
    (FWD, "three_blocks"): [("EP * NK >= 2048 ? 1 : 2", "EP * NK >= 2048 ? 1 : 3")],
    (BWD, "no_row_mma"): [("if (kc < nk) {", "if (false) {")],
    (BWD, "no_key_phase"): [("if (kr0 < LKP) {\n      // Steps", "if (false) {\n      // Steps")],
    (BWD, "no_dropout_bits"): [("if (DROPOUT) {  // the slab's keep bits", "if (false) {  //")],
    (FIXED, "ballot_search"): [(
        """  int e = 0;
  for (int hi = count - 1; e < hi;) {
    const int mid = (e + hi + 1) / 2;
    if (group.block_start[mid] <= b)
      e = mid;
    else
      hi = mid - 1;
  }""", """  int e = -1;
#pragma unroll
  for (int k = 0; k < kMaxGroup; k += 32) {
    const int i = k + (threadIdx.x & 31);
    e += __popc(__ballot_sync(0xffffffffu, i < count && group.block_start[i] <= b));
  }""")],
    (FIXED, "key_first"): [
        ("  const uint2 key = STOCHASTIC ? philox_key(seed) : make_uint2(0u, 0u);\n", ""),
        ("  const int b = blockIdx.x;\n",
         "  const int b = blockIdx.x;\n"
         "  const uint2 key = STOCHASTIC ? philox_key(seed) : make_uint2(0u, 0u);\n")],
    (FIXED, "small_table"): [("constexpr int kMaxGroup = 128;", "constexpr int kMaxGroup = 2;")],
    (FIXED, "t_zero"): [("static_cast<unsigned>(g >> 32), t, 0u), key);",
                         "static_cast<unsigned>(g >> 32), 0u, 0u), key);")],
    (FIXED, "vec_only"): [("  if (group.vec[e])\n", "  if (true)\n")],
    (FIXED, "no_philox"): [("    if (STOCHASTIC) {\n      const uint4 w",
                            "    if (false) {\n      const uint4 w")],
    (FIXED, "grid_y"): [
        ("""  const int b = blockIdx.x;
  int e = 0;
  for (int hi = count - 1; e < hi;) {
    const int mid = (e + hi + 1) / 2;
    if (group.block_start[mid] <= b)
      e = mid;
    else
      hi = mid - 1;
  }""", """  const int e = blockIdx.y;
  const int b = group.block_start[e] + blockIdx.x;
  if (b >= group.block_start[e + 1]) return;"""),
        ("  int blocks = 0;\n", "  int blocks = 0, widest = 0;\n"),
        ("    blocks += need < kMaxBlocks ? (int)need : kMaxBlocks;\n",
         "    blocks += need < kMaxBlocks ? (int)need : kMaxBlocks;\n"
         "    widest = need > widest ? (need < kMaxBlocks ? (int)need : kMaxBlocks) : widest;\n"),
        ("<<<blocks, kThreads", "<<<dim3(widest, count), kThreads")],
}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers, sizes, then the scalars and the stream.
ARGTYPES = {
    MHA: [_P] * 4 + [_I] * 6 + [_F, _I, _I, _I, _P],
    FWD: [_P] * 6 + [_I] * 5 + [_F, _I, ctypes.c_uint32, _F, _I, _P],
    BWD: [_P] * 10 + [_I] * 5 + [_F, _I, ctypes.c_uint32, _F, _I, _P],
    CODEWORD: [_P] * 3 + [ctypes.c_longlong, _I, _P],
    LSQ: [_P] * 4 + [ctypes.c_longlong, _I, _F, _F, _F, _P],
    GROUPED: [_P, _I, _I, _F, _F, _F, _I, _P, _P],
    SINGLE: [_P, _P, ctypes.c_longlong, _F, _F, _F, _I, _P, _P],
}


def build(kernel, variant, out_dir, csrc=None):
    """The library of ``kernel`` with ``variant``'s cuts, or built from
    ``csrc`` (a baseline's source directory) when given."""
    from channelestimationtransformer_torch.ops.cuda import _build

    csrc = csrc or _build.CSRC
    src = (csrc / f"{kernel}.cu").read_text()
    for old, new in CUTS.get((kernel, variant), []):
        if old not in src:
            raise RuntimeError(f"{kernel} {variant}: statement not found: {old!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{kernel}_{variant}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{kernel}_{variant}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    return lib


def time_us(torch, fn, inner=20, reps=5):
    """Median time of one call over ``reps`` replays of a CUDA graph of
    ``inner`` calls (no host launch cost: the codeword calls are ~4 us)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner * 1e3)
    return sorted(times)[reps // 2]


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream  # the capture stream inside a graph


def mha_call(torch, fn, shape):
    """An xl encoder call at L ``l`` in ``dtype`` on ``route`` (0 mma, 1 wgmma)."""
    l, dtype, route = shape
    b, h, e = 64, 8, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    to = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v = (torch.randn(b, l, h, e, generator=g, device="cuda").to(to) for _ in range(3))
    o = torch.empty_like(q)
    return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, l, l, e, e,
                      e ** -0.5, 0, DTYPES[dtype], route, _stream(torch))


DTYPES = {"f32": 0, "bf16": 1}  # the attention kernels' dtype codes


def fwd_call(torch, fn, shape):
    lq, lk, causal, dtype = shape
    b, h, e = 256, 8, 16
    g = torch.Generator(device="cuda").manual_seed(2)
    to = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.randn(b, lq, h, e, generator=g, device="cuda").to(to)
    k, v = (torch.randn(b, lk, h, e, generator=g, device="cuda").to(to) for _ in range(2))
    o = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device="cuda")
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    tensors = (q, k, v, o, lse, seed)  # held by the closure: the call reads them
    return lambda: fn(*(t.data_ptr() for t in tensors), b, h, lq, lk, e, e ** -0.5, causal,
                      int(0.95 * 2**32), 1 / 0.95, DTYPES[dtype], _stream(torch))


def codeword_call(torch, fn, n, lsq):
    from channelestimationtransformer_torch.ops.quant.codebooks import lsq_fibbinary_codebook

    cb = torch.tensor(lsq_fibbinary_codebook(8), dtype=torch.float32, device="cuda")
    w = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    y = torch.empty_like(w)
    if not lsq:
        x = w.clamp(-128, 127)
        tensors = (x, cb, y)
        return lambda: fn(*(t.data_ptr() for t in tensors), n, cb.numel(), _stream(torch))
    step = torch.tensor(0.01, device="cuda")
    tensors = (w, step, cb, y)
    return lambda: fn(*(t.data_ptr() for t in tensors), n, cb.numel(), 1.0 / (n * 127) ** 0.5,
                      -128.0, 127.0, _stream(torch))


def _ptq_tensors(torch, shapes=FLAGSHIP_TENSORS):
    g = torch.Generator(device="cuda").manual_seed(4)
    xs = [torch.randn(shape, generator=g, device="cuda") * 4 for shape in shapes]
    return xs, [torch.empty_like(x) for x in xs]


def fixed_call(torch, fn, case):
    """One quantization at wl 8, fl 4, clamp, nearest or stochastic, of the
    72 tensors (or of one 2^20-element tensor, ``big``): ``grouped`` (one
    launch), ``per_tensor`` (a group of one a tensor) or ``single`` (a call
    of the single-tensor entry a tensor)."""
    how, stochastic, big = case
    xs, ys = _ptq_tensors(torch, [(1 << 20,)] if big else FLAGSHIP_TENSORS)
    if how == "views":  # the 72 tensors back to back in one buffer
        flat_x, flat_y = torch.cat([x.reshape(-1) for x in xs]), torch.empty(
            sum(x.numel() for x in xs), device="cuda")
        xs = list(flat_x.split([x.numel() for x in xs]))
        ys = list(flat_y.split([x.numel() for x in xs]))
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    scalars = (16.0, -8.0, 8.0 - 2.0 ** -4, 1, seed.data_ptr() if stochastic else None)
    tables = [(ctypes.c_longlong * 3)(x.data_ptr(), y.data_ptr(), x.numel())
              for x, y in zip(xs, ys)]
    table = (ctypes.c_longlong * (3 * len(xs)))(*[v for t in tables for v in t])

    def run():
        if how == "single":
            errs = [fn(x.data_ptr(), y.data_ptr(), x.numel(), *scalars, _stream(torch))
                    for x, y in zip(xs, ys)]
        elif how == "per_tensor":
            errs = [fn(t, 1, 0, *scalars, _stream(torch)) for t in tables]
        else:
            errs = [fn(table, len(xs), 0, *scalars, _stream(torch))]
        return max(map(abs, errs))
    run.inputs = (xs, ys, seed)  # the launches read them
    return run


def host_us(torch, fn, inner=20, reps=5):
    """Host-clock time of one eager call, median of ``reps`` rounds of
    ``inner`` calls that end in a synchronise."""
    import time

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / inner * 1e6)
    return sorted(times)[reps // 2]


def fixed_wrapper_host_times(torch):
    """This checkout's Python wrappers and the two output allocations, host
    time per quantization of the 72 tensors."""
    from channelestimationtransformer_torch.ops.cuda import quant

    xs, _ = _ptq_tensors(torch)
    sizes = [x.numel() for x in xs]

    def flat():
        parts = torch.empty(sum(sizes), device="cuda").split(sizes)
        return [p.view(x.shape) for p, x in zip(parts, xs)]
    cells = {
        "grouped wrapper": lambda: quant.fused_fixed_point_quantize_grouped(xs, 8, 4),
        "72 single-tensor wrapper calls": lambda: [quant.fused_fixed_point_quantize(x, 8, 4)
                                                   for x in xs],
        "outputs as one flat buffer": flat,
        "outputs by 72 empty_like": lambda: [torch.empty_like(x) for x in xs],
    }
    return ", ".join(f"{name} {host_us(torch, fn):.1f}" for name, fn in cells.items())


def bwd_call(torch, fn, shape):
    l, dtype = shape
    b, h, e = 256, 8, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    to = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, o, do = (torch.randn(b, l, h, e, generator=g, device="cuda").to(to)
                      for _ in range(5))
    lse = torch.randn(b, h, l, generator=g, device="cuda").abs() + 3
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    tensors = (q, k, v, o, do, lse, seed, dq, dk, dv)
    return lambda: fn(*(t.data_ptr() for t in tensors), b, h, l, l, e, e ** -0.5, 0,
                      int(0.95 * 2**32), 1 / 0.95, DTYPES[dtype], _stream(torch))


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=CSRC_DIR",
                        help="also build and time every kernel from this source directory")
    kernels = (MHA, FWD, BWD, CODEWORD, FIXED)
    parser.add_argument("--only", action="append", choices=kernels,
                        help="build and time only this kernel (repeatable)")
    args = parser.parse_args(argv)
    kernels = tuple(args.only or kernels)
    baselines = dict(b.split("=", 1) for b in args.baseline)
    if not torch.cuda.is_available():
        raise SystemExit("attention_ablation.py runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = ([(k, "full", None) for k in kernels]
              + [(k, v, None) for k, v in CUTS if k in kernels]
              + [(k, name, pathlib.Path(d).resolve()) for name, d in baselines.items()
                 for k in kernels])
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(((k, v) for k, v, _ in builds),
                        pool.map(lambda b: build(b[0], b[1], out_dir, b[2]), builds)))
    print(f"card: {card}", flush=True)
    fwd_shapes = ((90, 90, 0), (45, 45, 0), (23, 23, 0), (12, 12, 0), (15, 15, 1), (15, 24, 0))
    # (library, entry, [(label, shape)], call maker)
    mha_shapes = ([(f"L {l} f32", (l, "f32", 0)) for l in (256, 128)]
                  + [(f"L {l} bf16 wgmma", (l, "bf16", 1)) for l in (256, 128, 64)]
                  + [(f"L {l} bf16 mma", (l, "bf16", 0)) for l in (256, 128)])
    sections = [(MHA, MHA, mha_shapes, mha_call),
                (FWD, FWD, [(f"Lq {s[0]} Lk {s[1]}{' causal' if s[2] else ''} {d}, "
                             "dropout and lse", s + (d,)) for d in DTYPES for s in fwd_shapes],
                 fwd_call),
                (BWD, BWD, [(f"L {l} {d}", (l, d)) for d in DTYPES for l in (90, 45)],
                 bwd_call)]
    for entry, mode in ((CODEWORD, "snap mode"), (LSQ, "lsq mode")):
        sections.append((CODEWORD, entry, [(f"n {n} {mode}", n) for n in (128 * 128, 128 * 64)],
                         lambda torch, fn, n, lsq=entry == LSQ: codeword_call(torch, fn, n, lsq)))
    for r in ("nearest", "stochastic"):
        st = r == "stochastic"
        sections.append((FIXED, GROUPED, [
            (f"72 tensors, one grouped launch, {r}", ("grouped", st, False)),
            (f"72 views of one buffer, one grouped launch, {r}", ("views", st, False)),
            (f"72 tensors, 72 groups of one, {r}", ("per_tensor", st, False)),
            (f"one 2^20 tensor, a group of one, {r}", ("grouped", st, True))], fixed_call))
        sections.append((FIXED, SINGLE, [
            (f"72 tensors, 72 single-tensor launches, {r}", ("single", st, False)),
            (f"one 2^20 tensor, single-tensor entry, {r}", ("single", st, True))], fixed_call))
    for kernel, entry, shapes, make in sections:
        if kernel not in kernels:
            continue
        for label, shape in shapes:
            cells = []
            for (name, variant), lib in libs.items():
                # A mode the library lacks is skipped: this checkout's fixed-point
                # library exports no SINGLE entry, and PR 6's no GROUPED one.
                fn = getattr(ctypes.CDLL(str(lib)), entry, None) if name == kernel else None
                if fn is None:
                    continue
                fn.argtypes = ARGTYPES[entry]
                fn.restype = ctypes.c_int
                call = make(torch, fn, shape)
                err = call()
                if err != 0 and (kernel, variant) in CUTS:  # a cut may refuse the shape
                    cells.append(f"{variant} refused (cudaError {err})")
                    continue
                if err != 0:
                    raise RuntimeError(f"{entry} {variant} launch failed")
                cell = f"{variant} {time_us(torch, call):.1f}"
                if kernel == FIXED:
                    cell += f" (host {host_us(torch, call):.1f})"
                cells.append(cell)
            if cells:
                print(f"{kernel} {label} (us): " + ", ".join(cells), flush=True)
    if FIXED in kernels:
        print(f"{FIXED} host us a quantization of 72 tensors: {fixed_wrapper_host_times(torch)}",
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    main()
