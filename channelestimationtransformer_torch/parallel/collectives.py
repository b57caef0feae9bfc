"""The data-parallel collectives of the training step: a sum over a
process group that autograd differentiates (its gradient is the same sum),
and the all-reduce of every gradient in one buffer.

``all_reduce_sum.bytes`` counts the payload of every all-reduce made here,
forward and backward, as the kernel wrappers count their launches; the
scaling driver reads it for the collective bytes a step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce_(y: torch.Tensor, group) -> torch.Tensor:
    """Sum ``y`` over ``group`` in place, counting its bytes."""
    dist.all_reduce(y, group=group)
    all_reduce_sum.bytes += y.numel() * y.element_size()
    return y


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce_(x.contiguous().clone(), group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        # Every rank's loss reads the sum, so each input's gradient is the
        # sum over the group of the gradients at the output.
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, the same on every rank;
    under autograd its backward sums the output's gradient likewise."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group)


all_reduce_sum.bytes = 0


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Replace each parameter's gradient by its sum over ``group``, in one
    all-reduce of one flat buffer (a parameter with no gradient counts as
    zeros, so every rank sends the same layout)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])
