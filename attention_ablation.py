"""Where the tensor-core attention kernels spend their time, on one NVIDIA card.

    python3 attention_ablation.py [--baseline NAME=CSRC_DIR ...]

Builds each of ``csrc/mha_attention_fwd.cu``, ``csrc/bd_attention_fwd.cu``
and ``csrc/bd_attention_bwd.cu`` as it is and with one part cut out, and
times every build on the path's calls (f32, random inputs): the ``xl``
encoder's L 256 and L 128 mha calls (B 64, H 8, E 128), the flagship's
forward calls with dropout 0.05 and the lse (B 256, H 8, E 16: the encoder's
L 90, 45, 23 and 12, the decoder's causal 15 and its 15 x 24 cross call)
and its L 90 and L 45 backward calls. A cut build computes wrong results;
only its time is read. The difference to the full build bounds what the
cut part costs where it does not overlap the rest:

- mha ``no_mma``: no Q K^T and no P V (loads, softmax and stores remain);
- mha ``no_prefetch``: the next K/V tile is not copied (the first is);
- fwd ``no_mma``: no S and no P V products;
- fwd ``no_dropout_bits``: no Philox calls (every key kept);
- fwd ``three_blocks``: not a cut: registers held for three blocks an SM
  (spills where the scores need more), for occupancy against spills;
- bwd ``no_row_mma``: no S, dP and dQ products in the row phase;
- bwd ``no_key_phase``: no dK and dV products;
- bwd ``no_dropout_bits``: no Philox calls (every key dropped).

It also times ``csrc/nearest_codeword.cu``, snap and LSQ modes, at the
flagship's two layer sizes (16,384 and 8,192 elements, the 67-entry
codebook).

``--baseline NAME=CSRC_DIR`` (repeatable) also builds every kernel from the
``.cu`` and ``.cuh`` files of another checkout's ``csrc`` directory (its C
interfaces must be this one's) and times it as the variant NAME, for
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
# (kernel, variant) -> (statement in the source, its replacement)
CUTS = {
    (MHA, "no_mma"): [("scores<NT, P::q, P::k, W>(s, sq + 16 * wi * P::q, kt, g, t);", ""),
                      ("pv<NT, NO, P::v>(acc, s, vt, g, t, lane);", "")],
    (MHA, "no_prefetch"): [("if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);",
                            "")],
    (FWD, "no_mma"): [("mma_split_tf32(s[n], ah, al, bh, bl);", ""),
                      ("mma_split_tf32(acc[n], ah, al, bh, bl);", "")],
    (FWD, "no_dropout_bits"): [("const bool dropout = seed != nullptr;",
                                "const bool dropout = false;")],
    (FWD, "three_blocks"): [("EP * NK >= 2048 ? 1 : 2", "EP * NK >= 2048 ? 1 : 3")],
    (BWD, "no_row_mma"): [("if (kc < nk) {", "if (false) {")],
    (BWD, "no_key_phase"): [("if (kr0 < LKP) {\n      // Steps", "if (false) {\n      // Steps")],
    (BWD, "no_dropout_bits"): [("if (DROPOUT) {  // the slab's keep bits", "if (false) {  //")],
}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers, sizes, then the scalars and the stream.
ARGTYPES = {
    MHA: [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P],
    FWD: [_P] * 6 + [_I] * 5 + [_F, _I, ctypes.c_uint32, _F, _I, _P],
    BWD: [_P] * 10 + [_I] * 5 + [_F, _I, ctypes.c_uint32, _F, _I, _P],
    CODEWORD: [_P] * 3 + [ctypes.c_longlong, _I, _P],
    LSQ: [_P] * 4 + [ctypes.c_longlong, _I, _F, _F, _F, _P],
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


def mha_call(torch, fn, l):
    b, h, e = 64, 8, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, l, h, e, generator=g, device="cuda") for _ in range(3))
    o = torch.empty_like(q)
    return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, l, l, e, e,
                      e ** -0.5, 0, 0, _stream(torch))


def fwd_call(torch, fn, shape):
    lq, lk, causal = shape
    b, h, e = 256, 8, 16
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(b, lq, h, e, generator=g, device="cuda")
    k, v = (torch.randn(b, lk, h, e, generator=g, device="cuda") for _ in range(2))
    o = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device="cuda")
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    tensors = (q, k, v, o, lse, seed)  # held by the closure: the call reads them
    return lambda: fn(*(t.data_ptr() for t in tensors), b, h, lq, lk, e, e ** -0.5, causal,
                      int(0.95 * 2**32), 1 / 0.95, 0, _stream(torch))


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


def bwd_call(torch, fn, l):
    b, h, e = 256, 8, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, o, do = (torch.randn(b, l, h, e, generator=g, device="cuda") for _ in range(5))
    lse = torch.randn(b, h, l, generator=g, device="cuda").abs() + 3
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    tensors = (q, k, v, o, do, lse, seed, dq, dk, dv)
    return lambda: fn(*(t.data_ptr() for t in tensors), b, h, l, l, e, e ** -0.5, 0,
                      int(0.95 * 2**32), 1 / 0.95, 0, _stream(torch))


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=CSRC_DIR",
                        help="also build and time every kernel from this source directory")
    args = parser.parse_args(argv)
    baselines = dict(b.split("=", 1) for b in args.baseline)
    if not torch.cuda.is_available():
        raise SystemExit("attention_ablation.py runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = (MHA, FWD, BWD, CODEWORD)
    builds = ([(k, "full", None) for k in kernels] + [(k, v, None) for k, v in CUTS]
              + [(k, name, pathlib.Path(d).resolve()) for name, d in baselines.items()
                 for k in kernels])
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(((k, v) for k, v, _ in builds),
                        pool.map(lambda b: build(b[0], b[1], out_dir, b[2]), builds)))
    print(f"card: {card}", flush=True)
    fwd_shapes = ((90, 90, 0), (45, 45, 0), (23, 23, 0), (12, 12, 0), (15, 15, 1), (15, 24, 0))
    # (library, entry, [(label, shape)], call maker)
    sections = [(MHA, MHA, [(f"L {l} f32", l) for l in (256, 128)], mha_call),
                (FWD, FWD, [(f"Lq {s[0]} Lk {s[1]}{' causal' if s[2] else ''} f32, "
                             "dropout and lse", s) for s in fwd_shapes], fwd_call),
                (BWD, BWD, [(f"L {l} f32", l) for l in (90, 45)], bwd_call)]
    for entry, mode in ((CODEWORD, "snap mode"), (LSQ, "lsq mode")):
        sections.append((CODEWORD, entry, [(f"n {n} {mode}", n) for n in (128 * 128, 128 * 64)],
                         lambda torch, fn, n, lsq=entry == LSQ: codeword_call(torch, fn, n, lsq)))
    for kernel, entry, shapes, make in sections:
        for label, shape in shapes:
            cells = []
            for (name, variant), lib in libs.items():
                fn = getattr(ctypes.CDLL(str(lib)), entry, None) if name == kernel else None
                if fn is None:
                    continue
                fn.argtypes = ARGTYPES[entry]
                fn.restype = ctypes.c_int
                call = make(torch, fn, shape)
                if call() != 0:
                    raise RuntimeError(f"{entry} {variant} launch failed")
                cells.append(f"{variant} {time_us(torch, call):.1f}")
            print(f"{kernel} {label} (us): " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    main()
