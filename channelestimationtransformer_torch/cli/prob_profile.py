"""Where ProbSparse attention's time goes (the counterpart of
``experiments/prob_profile.py``): ``prob_sparse_attention`` forward and
forward + backward at the flagship's shapes (encoder ``[256, 90, 8, 16]``
unmasked, decoder ``[256, 15, 8, 16]`` masked) against ``full_attention``,
then the prob op cut after each of its five stages (sampled scores, top-k,
selected scores, softmax update, scatter) to find the hot one.

Both are the port's plain torch paths, as JAX's are XLA work. Each row is
the median of 3 runs of 10 calls, host clock to a synchronise (the first
call builds and warms). The stage ablation is :func:`prob_pieces`, the
port's copy of JAX's (``:56-109``), fed an ``index_sample`` drawn once from
a generator seeded 7 (JAX's ``jax.random.key(7)``)::

    python -m channelestimationtransformer_torch.cli.prob_profile --out weights/prob_profile.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

import numpy as np
import torch

from ..core.runtime import resolve_device
from ..models.attention import (
    draw_index_sample,
    full_attention,
    prob_sizes,
    prob_sparse_attention,
)
from ._study import add_device_arg

REPS = 10
ENC_SHAPE = (256, 90, 8, 16)  # the encoder's top level, unmasked
DEC_SHAPE = (256, 15, 8, 16)  # the decoder's self-attention, masked


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, *args, device) -> float:
    """Median of 3 runs of ``REPS`` calls, ms a call; one call first."""
    fn(*args)
    sync(device)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn(*args)
        sync(device)
        times.append((time.perf_counter() - t0) / REPS)
    return statistics.median(times) * 1000


def grad_of(fn):
    """``d sum(fn(q, k, v)) / dq`` (JAX ``jax.grad``'s first argument)."""
    def run(q, k, v):
        q = q.detach().requires_grad_()
        return torch.autograd.grad(fn(q, k, v).sum(), q)[0]
    return run


def prob_pieces(q, k, v, *, mask_flag: bool, factor: int, index_sample: torch.Tensor,
                upto: int):
    """ProbSparse attention in JAX's stage layout (one-hot sampling and
    selection products), stopped after stage ``upto`` (1..5)."""
    b, l_q, h, e = q.shape
    l_k = k.shape[1]
    q_, k_, v_ = (t.transpose(1, 2) for t in (q, k, v))
    _, n_top = prob_sizes(l_q, l_k, factor)
    qk_full = torch.einsum("bhle,bhse->bhls", q_, k_)
    onehot = (index_sample[..., None] == torch.arange(l_k, device=q.device)).to(q_.dtype)
    qk_sample = torch.einsum("bhlk,lsk->bhls", qk_full, onehot)
    if upto == 1:
        return qk_sample
    m = qk_sample.amax(dim=-1) - qk_sample.sum(dim=-1) / l_k
    # jax.lax.top_k: ties to the lower index, as a stable descending sort.
    m_top = torch.sort(m, dim=-1, descending=True, stable=True).indices[..., :n_top]
    if upto == 2:
        return m_top.to(q.dtype) * 1e-6 + qk_sample.sum()
    sel = (m_top[..., None] == torch.arange(l_q, device=q.device)).to(q_.dtype)
    scores = torch.einsum("bhul,bhlk->bhuk", sel, qk_full) / math.sqrt(e)
    if upto == 3:
        return scores
    if mask_flag:
        cm = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).triu(1)
        scores = torch.where(cm[m_top], torch.finfo(torch.float32).min, scores)
        context = v_.cumsum(dim=-2)
    else:
        context = v_.mean(dim=-2, keepdim=True).expand(b, h, l_q, v_.shape[-1])
    update = torch.einsum("bhuk,bhkd->bhud", torch.softmax(scores, dim=-1), v_)
    if upto == 4:
        return update + context.sum() * 0.0
    context = context.scatter(2, m_top[..., None].expand(*m_top.shape, v_.shape[-1]),
                              update.to(context.dtype))
    return context.transpose(1, 2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile ProbSparse attention against full.")
    p.add_argument("--out", default="weights/prob_profile.json")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rows = {}

    def rec(name, val):
        rows[name] = val
        print(json.dumps({name: round(val, 3)}), flush=True)

    rng = np.random.default_rng(0)

    def mk(b, l, h, e):
        return tuple(torch.as_tensor(rng.normal(size=(b, l, h, e)), dtype=torch.float32,
                                     device=device) for _ in range(3))

    enc, dec = mk(*ENC_SHAPE), mk(*DEC_SHAPE)
    samples = {l: draw_index_sample(l, l, 5, torch.Generator(device=device).manual_seed(7),
                                    device) for l in (ENC_SHAPE[1], DEC_SHAPE[1])}

    def full(mask_flag):
        return lambda q, k, v: full_attention(q, k, v, mask_flag=mask_flag)[0]

    def prob(mask_flag):
        return lambda q, k, v: prob_sparse_attention(
            q, k, v, mask_flag=mask_flag, factor=5, index_sample=samples[q.shape[1]])[0]

    # --- forward-only comparisons ---
    with torch.no_grad():
        rec("fwd_full_enc", timeit(full(False), *enc, device=device))
        rec("fwd_prob_enc", timeit(prob(False), *enc, device=device))
        rec("fwd_full_dec", timeit(full(True), *dec, device=device))
        rec("fwd_prob_dec", timeit(prob(True), *dec, device=device))

    # --- fwd+bwd comparisons ---
    rec("bwd_full_enc", timeit(grad_of(full(False)), *enc, device=device))
    rec("bwd_prob_enc", timeit(grad_of(prob(False)), *enc, device=device))
    rec("bwd_full_dec", timeit(grad_of(full(True)), *dec, device=device))
    rec("bwd_prob_dec", timeit(grad_of(prob(True)), *dec, device=device))

    # --- stage ablation (fwd+bwd) ---
    for upto, name in [(1, "qk_sample"), (2, "topk"), (3, "sel_scores"),
                       (4, "softmax_update"), (5, "scatter_full")]:
        for part, mask_flag, qkv in (("enc", False, enc), ("dec", True, dec)):
            fn = grad_of(lambda q, k, v, u=upto, mf=mask_flag: prob_pieces(
                q, k, v, mask_flag=mf, factor=5, index_sample=samples[q.shape[1]], upto=u))
            rec(f"bwd_{part}_upto_{upto}_{name}", timeit(fn, *qkv, device=device))

    out = {k_: round(v_, 4) for k_, v_ in rows.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
