"""Structured magnitude pruning (JAX counterpart ``ops/prune.py``; reference
``Pruning(WIP)/prune.py:132-314``: neural_compressor's ``snip_momentum``
pruner, 4x1 block pattern, 90% target sparsity, gradual schedule).

The blocks are JAX's: 4 consecutive *input* rows x 1 output column of a
flax kernel ``[in, out]``, the input rows padded with zeros to a multiple
of 4; a conv kernel ``[K, C_in, C_out]`` is flattened K-major to
``[K * C_in, C_out]`` first. The port's ``Dense.weight`` is ``[out, in]``
and its conv weight ``[C_out, C_in, K]``, so :func:`flax_matrix` maps a
port weight to JAX's matrix and a mask here is JAX's mask in the port's
layout. A block's score is its four magnitudes added left to right, as
XLA's reduction adds them; the threshold is the sorted scores at
``int32(float32(sparsity) * (n - 1))``, and blocks scoring above it stay.

:func:`apply_pruning` transforms every matched weight of one shape in one
batch (the flagship has three shapes): a sort per shape, not per tensor.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .quant.settings import QUANT_KERNEL_MARKERS


def _flax_matrices(stack: torch.Tensor, shape) -> torch.Tensor:
    """JAX's ``kernel.reshape(-1, out)`` of each port weight of ``stack``
    ``[T, *shape]``: ``[T, in, out]`` for dense weights ``[out, in]``,
    ``[T, K * C_in, C_out]`` for conv weights ``[C_out, C_in, K]``."""
    if len(shape) == 2:
        return stack.transpose(-1, -2)
    return stack.permute(0, 3, 2, 1).reshape(stack.shape[0], -1, shape[0])


def flax_matrix(w: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``kernel.reshape(-1, out)`` of one port weight."""
    return _flax_matrices(w[None], w.shape)[0]


def _from_flax_matrices(m: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`_flax_matrices`."""
    if len(shape) == 2:
        return m.transpose(-1, -2)
    c_out, c_in, k = shape
    return m.reshape(m.shape[0], k, c_in, c_out).permute(0, 3, 2, 1)


def _scores(mats: torch.Tensor, block: int) -> torch.Tensor:
    """Block L1 scores of flax matrices ``[..., rows, out]`` ->
    ``[..., rows / block, out]``, the four magnitudes added left to right."""
    a = mats.abs()
    pad = (-a.shape[-2]) % block
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    a = a.reshape(*a.shape[:-2], -1, block, a.shape[-1])
    s = a[..., 0, :]
    for j in range(1, block):
        s = s + a[..., j, :]
    return s


def block_scores(w: torch.Tensor, block: int = 4) -> torch.Tensor:
    """L1 score of every block of ``block`` input rows x 1 output of a
    weight, as JAX's ``[in / block, out]`` scores transposed: ``[out, nb]``
    (a 1-D tensor: its magnitudes)."""
    if w.dim() == 1:
        return w.abs()
    return _scores(flax_matrix(w), block).t()


def _keep(mats: torch.Tensor, sparsity: float, block: int) -> torch.Tensor:
    """Keep-masks of flax matrices ``[T, rows, out]`` at ``sparsity``."""
    scores = _scores(mats, block)
    flat = scores.reshape(scores.shape[0], -1)
    k = int(np.float32(sparsity) * np.float32(flat.shape[-1] - 1))
    thr = torch.sort(flat, dim=-1).values[:, k].view(-1, 1, 1)
    keep = scores > thr
    return keep.repeat_interleave(block, dim=-2)[:, :mats.shape[-2]]


def block_magnitude_mask(w: torch.Tensor, sparsity: float, block: int = 4) -> torch.Tensor:
    """Boolean keep-mask of ``w``'s shape with the 4x1 structured pattern at
    ``sparsity`` (all kept at ``sparsity <= 0``, as JAX's select)."""
    if w.dim() < 2 or np.float32(sparsity) <= 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    return _from_flax_matrices(_keep(_flax_matrices(w[None], w.shape), sparsity, block),
                               w.shape)[0]


def snip_scores(w: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """SNIP salience ``|w * grad|`` (the ``snip_momentum`` criterion's base score)."""
    return (w * grad).abs()


def cubic_sparsity_schedule(step: int, *, target: float = 0.9, start_step: int = 0,
                            end_step: int = 1000, initial: float = 0.0) -> float:
    """neural_compressor's gradual ramp: cubic from ``initial`` to
    ``target`` between the start and end steps."""
    if step <= start_step:
        return initial
    if step >= end_step:
        return target
    t = (step - start_step) / (end_step - start_step)
    return target + (initial - target) * (1.0 - t) ** 3


def _matched(params: Mapping[str, torch.Tensor], markers):
    return [n for n, w in params.items() if any(n.endswith(m) for m in markers) and w.dim() >= 2]


def apply_pruning(params: Mapping[str, torch.Tensor], sparsity: float, *, block: int = 4,
                  markers=QUANT_KERNEL_MARKERS) -> dict:
    """``params`` with the lowest-scoring 4x1 blocks of every matched weight
    zeroed (a new dict; the other tensors as they are, and all of them at
    ``sparsity <= 0``). The weights of one shape go through one batch."""
    out = dict(params)
    if np.float32(sparsity) <= 0.0:
        return out
    shapes = {}
    for name in _matched(params, markers):
        shapes.setdefault(tuple(params[name].shape), []).append(name)
    for shape, names in shapes.items():
        stack = torch.stack([params[n] for n in names])
        keep = _from_flax_matrices(_keep(_flax_matrices(stack, shape), sparsity, block), shape)
        pruned = torch.where(keep, stack, 0.0)
        out.update((n, pruned[i]) for i, n in enumerate(names))
    return out


def measured_sparsity(params: Mapping[str, torch.Tensor], markers=QUANT_KERNEL_MARKERS) -> float:
    """Fraction of exactly-zero entries across the matched weights."""
    names = _matched(params, markers)
    if not names:
        return 0.0
    zeros = torch.stack([(params[n] == 0.0).sum() for n in names]).sum()
    return int(zeros) / sum(params[n].numel() for n in names)
