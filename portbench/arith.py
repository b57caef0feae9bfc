"""The yardstick's arithmetic: the card's peaks, the least time of an
attention call, the attention calls of an InformerStack forward.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): HBM at
3.35 TB/s; 989 TFLOP/s in bf16 and fp16 on the tensor cores; 495 in TF32;
67 in float32 on the CUDA cores. A model's share of the peak takes the
dtype's rate with TF32 off (67 for float32). An attention kernel's bound
takes the tensor-core rate of its dtype (495 for float32, the fastest any
float32 kernel can multiply), so no kernel can read above its roofline.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
MODEL_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
ATTN_PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12, "float16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _pairs(l_q: int, l_k: int, causal: bool) -> int:
    """(query, key) pairs a call computes: all, or those on or below the
    diagonal."""
    return sum(min(i + 1, l_k) for i in range(l_q)) if causal else l_q * l_k


def _bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / ATTN_PEAK_FLOPS[dtype])


def fwd_bound_s(l_q, l_k, causal, dtype, *, b, h, e, d=None, with_lse=False) -> float:
    """Least seconds of one attention forward: Q, K, V read once and O (and
    the f32 row log-sum-exp) written once at the HBM rate, or 2 (E + D)
    FLOPs a computed pair at the dtype's tensor-core rate, the larger."""
    d = e if d is None else d
    size = DTYPE_BYTES[dtype]
    nbytes = size * b * h * (e + d) * (l_q + l_k) + (4 * b * h * l_q if with_lse else 0)
    return _bound_s(nbytes, 2 * b * h * (e + d) * _pairs(l_q, l_k, causal), dtype)


def bwd_bound_s(l_q, l_k, causal, dtype, *, b, h, e) -> float:
    """Least seconds of one attention backward: Q, K, V, O, dO and the log-
    sum-exp read once, dQ, dK, dV written once; or 10 E FLOPs a computed
    pair (QKᵀ and dO Vᵀ once each, dQ, dK, dV), the larger."""
    size = DTYPE_BYTES[dtype]
    nbytes = size * b * h * e * (4 * l_q + 4 * l_k) + 4 * b * h * l_q
    return _bound_s(nbytes, 10 * b * h * e * _pairs(l_q, l_k, causal), dtype)


def distilled_length(length: int) -> int:
    """Slots after one distilling conv (max-pool kernel 3, stride 2, pad 1)."""
    return (length - 1) // 2 + 1


def attention_calls(model: dict) -> list[tuple[int, int, int, bool]]:
    """``(l_q, l_k, E, causal)`` of every attention call of one forward, in
    order: encoder ``i`` reads the last ``L // 2**i`` slots and halves them
    after each layer but its last; then each decoder layer's causal self
    call and its cross call over the stacked encoder output."""
    e = model["d_model"] // model["n_heads"]
    calls, enc_out = [], 0
    for i, n_layers in enumerate(model["e_layers"]):
        length = model["seq_len"] // 2**i
        for j in range(n_layers):
            calls.append((length, length, e, False))
            if model["distil"] and j < n_layers - 1:
                length = distilled_length(length)
        enc_out += length
    l_dec = model["label_len"] + model["pred_len"]
    for _ in range(model["d_layers"]):
        calls += [(l_dec, l_dec, e, True), (l_dec, enc_out, e, False)]
    return calls


# The attention routing of the port (``models/attention.py``): the bd kernels
# take a call when l_k <= 128, l_q <= 512 and E <= 64, in training too; the
# mha kernel takes the rest in eval mode when E and D <= 128.
BD_MAX_LK, BD_MAX_LQ, BD_MAX_E = 128, 512, 64
MHA_MAX_WIDTH = 128


def bd_calls(model: dict) -> list:
    return [c for c in attention_calls(model)
            if c[1] <= BD_MAX_LK and c[0] <= BD_MAX_LQ and c[2] <= BD_MAX_E]


def mha_calls(model: dict) -> list:
    bd = set(bd_calls(model))
    return [c for c in attention_calls(model) if c not in bd and c[2] <= MHA_MAX_WIDTH]


def roofline_share(ctx, patterns, calls: list, bound) -> float | None:
    """Percent of its roofline that a kernel reaches over a traced slice:
    the least seconds of every call (``bound(call)`` each, ``calls`` a unit)
    over the summed device seconds of the kernel rows whose name holds one
    of ``patterns``. None when the slice has no such row, or not one row a
    call (the calls' shapes are then not known)."""
    n, seconds = ctx.trace.kernel_time(patterns)
    if n == 0 or n != ctx.units * len(calls):
        return None
    return 100.0 * ctx.units * sum(bound(c) for c in calls) / seconds
