"""Real int8 inference serving, past fake quantization (JAX counterpart
``ops/quant/serving.py``).

The reference's quantization study only simulates quantization. This module
runs the quantized network for real, in two modes:

- **W8A8**: weights stored as int8 (per-output-channel symmetric scales, or
  the trained LSQ ``step_size`` where the layer has one), activations
  quantized per tensor (symmetric abs-max) on every call, matmuls int8 x
  int8 -> int32 through :func:`int8_matmul` (``torch._int_mm``: cuBLAS on
  the card);
- **weight_only**: int8 weights, bf16 activations and products with an f32
  result (:func:`bf16_matmul_f32`), the per-channel dequantization folded
  into the epilogue.

Following the reference's quantization scope, only the attention
projections, the FFN layers and the distil convs are quantized; the token
embeddings and the final projection stay float.

The table is keyed by module path: the port's modules carry the flax names
(``utils/convert.py``), so a key is the JAX table's path joined by ``.``.
Usage::

    table = build_int8_table(model)
    with torch.no_grad(), serving_intercept(model, table):
        pred = model(x_enc, x_dec)   # int8 matmuls

flax's interceptors see every module call by its path; torch modules do
not know their path, so :func:`serving_intercept` and
:func:`model_rate_report` take the model as their first argument.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Module path names never quantized (reference scope: embeddings + final
# projection stay FP32).
DEFAULT_EXCLUDE = ("projection", "enc_embedding", "dec_embedding")
MODES = ("w8a8", "weight_only")


def _quantize_kernel(kernel: torch.Tensor, nbits: int, *, bias=None, step_size=None) -> dict:
    """int8 weights + f32 scale for one ``[in, out]`` kernel (JAX
    ``serving.py:49-66``): the trained LSQ ``step_size`` (by absolute value,
    at least 1e-12) when given, else the per-output-channel abs-max over
    ``qp``. The JAX package builds its table eagerly, where ``/ qp`` is a
    true division (under ``jax.jit`` XLA would multiply by ``1 / qp``); so
    is it here on both devices: ``qp`` is a tensor, since PyTorch's CUDA
    division by a Python number multiplies by its reciprocal."""
    kernel = kernel.detach().float()
    qp = 2 ** (nbits - 1) - 1
    qn = -(2 ** (nbits - 1))
    if step_size is not None:
        scale = torch.clamp_min(step_size.detach().float().abs(), 1e-12)
    else:
        amax = kernel.abs().amax(dim=0)  # [N] per out-channel
        scale = torch.clamp_min(amax / amax.new_tensor(qp), 1e-12)
    w_q = torch.clamp(torch.round(kernel / scale), qn, qp).to(torch.int8)
    return {
        "w_q": w_q,
        "w_scale": scale.to(torch.float32),
        "bias": bias.detach().float() if bias is not None else None,
    }


def build_int8_table(
    model: nn.Module,
    *,
    nbits: int = 8,
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE,
) -> Dict[str, dict]:
    """Quantize every eligible weight of ``model`` (JAX ``serving.py:69-99``):
    each module whose own ``weight`` is 2-D (``Dense``, ``DenseLSQ``: the
    attention projections and FFN layers) or 3-D (the 3-tap distil
    ``ConvLayer``s, as im2col ``[K * C_in, C_out]`` matrices with ``taps``),
    unless a component of its path is in ``exclude``. Entries are built on
    the weights' device. A 2-D weight is torch's ``[out, in]``, so its
    transpose is JAX's kernel; a conv weight ``[C_out, C_in, K]`` becomes
    JAX's tap-major ``[K * C_in, C_out]``, the column order of
    :func:`int8_circular_conv_apply`."""
    table: Dict[str, dict] = {}
    for name, module in model.named_modules():
        weight = module._parameters.get("weight")
        if weight is None or weight.ndim not in (2, 3):
            continue
        if any(p in exclude for p in name.split(".")):
            continue
        extra = dict(bias=module._parameters.get("bias"),
                     step_size=module._parameters.get("step_size"))
        if weight.ndim == 2:
            table[name] = _quantize_kernel(weight.detach().T, nbits, **extra)
        else:
            c_out, c_in, k = weight.shape
            kernel = weight.detach().permute(2, 1, 0).reshape(k * c_in, c_out)
            table[name] = dict(_quantize_kernel(kernel, nbits, **extra), taps=k)
    return table


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``[m, k]`` x int8 ``[k, n]`` -> int32 ``[m, n]`` by
    ``torch._int_mm``: cuBLAS's int8 GEMM on the card (each call there adds
    one to ``int8_matmul.launches``), an exact int32 product on the CPU.
    cuBLAS takes m > 16 and k, n multiples of 8; any other shape raises
    ``ValueError`` on either device (there is no float fallback)."""
    m, k = a.shape
    n = b.shape[1]
    if not (m > 16 and k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"int8_matmul takes m > 16 and k, n multiples of 8 (cuBLAS's "
                         f"int8 GEMM), got m {m}, k {k}, n {n}")
    out = torch._int_mm(a, b)
    if a.is_cuda:
        int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def bf16_matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``[m, k]`` x bf16 ``[k, n]`` with the products summed and
    returned in f32, as JAX's ``dot_general(..., preferred_element_type=f32)``
    (a bf16 result would keep ~3 significant digits). On the card this is
    ``torch.mm(a, b, out_dtype=torch.float32)``, one cuBLAS bf16 GEMM with
    f32 accumulation and output (each call adds one to
    ``bf16_matmul_f32.launches``); on the CPU, which has no kernel for that
    op, the bf16 operands are widened to f32 (exact) and multiplied in f32."""
    if a.is_cuda:
        out = torch.mm(a, b, out_dtype=torch.float32)
        bf16_matmul_f32.launches += 1
        return out
    return a.float() @ b.float()


bf16_matmul_f32.launches = 0


def _rescale(y: torch.Tensor, scale: torch.Tensor, entry: dict, shape, out_dtype):
    y = y.float() * scale
    if entry["bias"] is not None:
        y = y + entry["bias"]
    return y.reshape(*shape[:-1], y.shape[-1]).to(out_dtype)


def int8_dense_apply(x: torch.Tensor, entry: dict) -> torch.Tensor:
    """W8A8 dense (JAX ``serving.py:102-117``): the activation's per-tensor
    abs-max scale, its int8 codes, int8 x int8 -> int32, then
    ``y * (a_scale * w_scale) + bias`` in f32, cast to ``x.dtype``. The scale
    is ``max|x| * (1 / 127)``: JAX writes ``/ 127.0``, which XLA turns into
    that product under ``jax.jit`` (the JAX driver's path)."""
    xf = x.float()
    a_scale = torch.clamp_min(xf.abs().max() * (1.0 / 127.0), 1e-12)
    x_q = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), entry["w_q"])
    return _rescale(y, a_scale * entry["w_scale"], entry, x.shape, x.dtype)


def int8_dense_weight_only_apply(x: torch.Tensor, entry: dict) -> torch.Tensor:
    """Weight-only int8 dense (JAX ``serving.py:120-142``): bf16 activations
    and int8 weights widened to bf16 (exact), their products summed in f32
    (:func:`bf16_matmul_f32`), then ``y * w_scale + bias``, cast to
    ``x.dtype``. With per-output-channel scales ``x @ (w_q * s) == (x @ w_q)
    * s``, so dequantization is one epilogue rescale."""
    y = bf16_matmul_f32(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                        entry["w_q"].to(torch.bfloat16))
    return _rescale(y, entry["w_scale"], entry, x.shape, x.dtype)


def int8_circular_conv_apply(x: torch.Tensor, entry: dict, *,
                             weight_only: bool = False) -> torch.Tensor:
    """Circular k-tap conv over ``[B, L, C]`` as an im2col int8 matmul (JAX
    ``serving.py:145-155``): tap ``t`` is ``x`` rolled by ``k // 2 - t``
    along L, so it sees ``x[l + t - k // 2]`` (``models/embed.circular_conv1d``)."""
    k = entry["taps"]
    pad = k // 2
    cols = torch.cat([torch.roll(x, pad - t, dims=1) for t in range(k)], dim=-1)
    apply = int8_dense_weight_only_apply if weight_only else int8_dense_apply
    return apply(cols, entry)


def _int8_conv_layer(module, x: torch.Tensor, entry: dict, *,
                     weight_only: bool = False) -> torch.Tensor:
    """Serve a distil ``ConvLayer`` (``models/encoder.py``; JAX
    ``serving.py:158-170``): the int8 circular conv, then the layer's own
    BatchNorm with its running statistics (eps 1e-5), ELU and max pooling
    (k 3, s 2, p 1)."""
    y = int8_circular_conv_apply(x, entry, weight_only=weight_only)
    bn = module.norm
    inv = torch.rsqrt(bn.running_var + 1e-5)
    y = (y - bn.running_mean) * inv * bn.weight + bn.bias
    y = F.elu(y)
    return F.max_pool1d(y.transpose(1, 2), kernel_size=3, stride=2, padding=1).transpose(1, 2)


def _served_forward(path, serve, hits):
    def forward(x):
        if hits is not None:
            hits.add(path)
        return serve(x)
    return forward


@contextlib.contextmanager
def serving_intercept(
    model: nn.Module,
    table: Dict[str, dict],
    hits: Optional[set] = None,
    *,
    mode: str = "w8a8",
):
    """Context manager (JAX ``serving.py:173-216``): inside it, every
    ``nn.Linear`` (``Dense``, ``DenseLSQ``) and distil ``ConvLayer`` of
    ``model`` whose path is in ``table`` runs the int8 function in place of
    its forward; on exit, even by an exception, each module gets its own
    forward back. ``mode``: ``"w8a8"`` or ``"weight_only"``; any other
    raises ``ValueError``. ``hits`` (optional): a set each served module's
    path is added to when it runs, so a caller can verify that the table
    matched. A table entry whose path names no such module is never served."""
    from ...models.encoder import ConvLayer

    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}")
    weight_only = mode == "weight_only"
    dense = int8_dense_weight_only_apply if weight_only else int8_dense_apply
    swapped = []
    try:
        for name, module in model.named_modules():
            entry = table.get(name)
            if entry is None:
                continue
            if isinstance(module, nn.Linear):
                serve = functools.partial(dense, entry=entry)
            elif isinstance(module, ConvLayer):
                serve = functools.partial(_int8_conv_layer, module, entry=entry,
                                          weight_only=weight_only)
            else:
                continue
            swapped.append((module, module.__dict__.get("forward")))
            module.forward = _served_forward(name, serve, hits)
        yield
    finally:
        for module, own in swapped:
            if own is None:
                del module.forward
            else:
                module.forward = own


def predict_int8(
    model: nn.Module,
    *args,
    nbits: int = 8,
    table: Optional[Dict[str, dict]] = None,
    mode: str = "w8a8",
    **kwargs,
):
    """Forward pass of ``model`` with every eligible layer served in int8
    (JAX ``serving.py:219-250``), without gradients. Raises
    ``RuntimeError`` if the intercept matched *no* table entry (the whole
    model ran in float), and warns when only some entries were run."""
    table = table if table is not None else build_int8_table(model, nbits=nbits)
    hits: set = set()
    with torch.no_grad(), serving_intercept(model, table, hits, mode=mode):
        out = model(*args, **kwargs)
    if table and not hits:
        raise RuntimeError(
            "predict_int8: int8 table matched no module path — the model ran "
            "entirely in float (paths renamed?)")
    if len(hits) < len(table):
        warnings.warn(
            f"predict_int8: only {len(hits)}/{len(table)} int8 table entries "
            "were exercised by this forward pass",
            stacklevel=2,
        )
    return out
