"""Where the tensor-core attention kernels spend their time, on one NVIDIA card.

    python3 attention_ablation.py

Builds each of ``csrc/mha_attention_fwd.cu`` and ``csrc/bd_attention_bwd.cu``
as it is and with one part cut out, and times every build on the path's
longest calls (f32, random inputs): the ``xl`` encoder's L 256 and L 128
mha calls (B 64, H 8, E 128) and the flagship's L 90 and L 45 backward
calls (B 256, H 8, E 16, dropout 0.05). A cut build computes wrong
results; only its time is read. The difference to the full build bounds
what the cut part costs where it does not overlap the rest:

- mha ``no_mma``: no Q K^T and no P V (loads, softmax and stores remain);
- mha ``no_prefetch``: the next K/V tile is not copied (the first is);
- bwd ``no_row_mma``: no S, dP and dQ products in the row phase;
- bwd ``no_key_phase``: no dK and dV products;
- bwd ``no_dropout_bits``: no Philox calls (every key dropped).

Times are CUDA-event windows of 20 launches, median of 5, after a warm-up.
Builds go to ``channelestimationtransformer_torch/build/ablation/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

MHA = "mha_attention_fwd"
BWD = "bd_attention_bwd"
# (kernel, variant) -> (statement in the source, its replacement)
CUTS = {
    (MHA, "no_mma"): [("scores<NT, P::q, P::k, W>(s, sq + 16 * wi * P::q, kt, g, t);", ""),
                      ("pv<NT, NO, P::v>(acc, s, vt, g, t, lane);", "")],
    (MHA, "no_prefetch"): [("if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);",
                            "")],
    (BWD, "no_row_mma"): [("if (kc < nk) {", "if (false) {")],
    (BWD, "no_key_phase"): [("if (kr0 < LKP) {\n      // Steps", "if (false) {\n      // Steps")],
    (BWD, "no_dropout_bits"): [("if (DROPOUT) {  // the slab's keep bits", "if (false) {  //")],
}


def build(kernel, variant, out_dir):
    from channelestimationtransformer_torch.ops.cuda import _build

    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in CUTS.get((kernel, variant), []):
        if old not in src:
            raise RuntimeError(f"{kernel} {variant}: statement not found: {old!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{kernel}_{variant}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{kernel}_{variant}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    return lib


def time_us(torch, fn, inner=20, reps=5):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner * 1e3)
    return sorted(times)[reps // 2]


def mha_call(torch, fn, l):
    b, h, e = 64, 8, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, l, h, e, generator=g, device="cuda") for _ in range(3))
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, l, l, e, e,
                      e ** -0.5, 0, 0, stream)


def bwd_call(torch, fn, l):
    b, h, e = 256, 8, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, o, do = (torch.randn(b, l, h, e, generator=g, device="cuda") for _ in range(5))
    lse = torch.randn(b, h, l, generator=g, device="cuda").abs() + 3
    seed = torch.tensor([12345], dtype=torch.int64, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, seed, dq, dk, dv)]
    return lambda: fn(*ptrs, b, h, l, l, e, e ** -0.5, 0, int(0.95 * 2**32), 1 / 0.95, 0, stream)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_ablation.py runs on a CUDA card")
    from channelestimationtransformer_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = [(MHA, "full"), (BWD, "full")] + list(CUTS)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda kv: build(*kv, out_dir), builds)))
    print(f"card: {card}", flush=True)
    for kernel, shapes, make in ((MHA, (256, 128), mha_call), (BWD, (90, 45), bwd_call)):
        for l in shapes:
            cells = []
            for (name, variant), lib in libs.items():
                if name != kernel:
                    continue
                fn = getattr(ctypes.CDLL(str(lib)), kernel)
                n_ptr = 4 if kernel == MHA else 10
                fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (6 if kernel == MHA else 5)
                               + ([ctypes.c_float, ctypes.c_int, ctypes.c_int] if kernel == MHA else
                                  [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                                   ctypes.c_int])
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                call = make(torch, fn, l)
                if call() != 0:
                    raise RuntimeError(f"{kernel} {variant} launch failed")
                cells.append(f"{variant} {time_us(torch, call):.1f}")
            print(f"{kernel} L {l} f32 (us): " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    main()
