"""Tensor parallelism over the mesh's ``model`` axis: a forward and a
training step on the rank's shards of the placements that
``parallel/sharding.py:param_shardings`` gives (JAX counterpart: GSPMD
carrying ``jax.jit(model.apply)`` through ``shard_params``' placements,
``parallel/sharding.py:1-8``).

:func:`tensor_parallel` keeps on each rank only its rows of every weight
placed at ``Shard(0)`` and marks the layer that owns it. Such a layer runs
column-parallel: in :func:`column_parallel` its input enters through the
identity, whose backward sums the input's gradient over the group, the
local matmul or conv computes the rank's output features, and an
all-gather along the last dim joins them (its backward takes the rank's
slice of the output gradient). The bias, replicated by the
rule, is added after the gather. Everything after a gather runs replicated
on every rank: BatchNorm, LayerNorm, every dropout and residual, and the
attention over all heads (GSPMD likewise gathers around a ``pallas_call``;
the bd kernel's Philox stream is keyed per launch and head, so local heads
would draw other masks than the replicated model). The numbers are the
replicated model's, and the replicated parameters' gradients come out equal
on every rank (:func:`replicated_grads_equal`).

The layers that run so are those that declare ``tp_group``: ``Dense``,
``TokenEmbedding`` and the distilling ``ConvLayer``. A ``Shard(0)`` weight
of any other layer raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .sharding import param_shardings


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # Each rank's local product saw the whole input: its gradient is the
        # sum of the ranks' partial ones.
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.n = group, y.shape[-1]
        return _all_gather(y, group, -1)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def column_parallel(fn, x: torch.Tensor, group) -> torch.Tensor:
    """``fn`` (a product with the rank's output rows of a weight) on the
    replicated ``x``, its output gathered along the last dim in rank order.
    Under autograd each rank's output gradient is its slice, and the
    gradient of ``x`` is summed over ``group``."""
    if x.requires_grad:
        x = _CopyToGroup.apply(x, group)
    return _GatherFeatures.apply(fn(x), group)


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Turn ``model`` into its tensor-parallel form over ``mesh``'s
    ``model`` axis, in place: every parameter that ``param_shardings``
    places at ``Shard(0)`` keeps this rank's rows, and its layer runs
    column-parallel. Every rank must hold the same full parameters before
    (the caller broadcasts them). A model axis of one changes nothing."""
    group = mesh.get_group("model")
    if dist.get_world_size(group) == 1:
        return model
    placements = param_shardings(model, mesh)
    for mod_name, module in model.named_modules():
        for name, p in list(module.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            if placements[full].is_replicate():
                continue
            if not hasattr(module, "tp_group") or name != "weight":
                raise NotImplementedError(
                    f"{full} ({type(module).__name__}) is sharded over the model axis, but only "
                    "Dense, TokenEmbedding and ConvLayer weights run column-parallel")
            rows = p.shape[0] // dist.get_world_size(group)
            r = dist.get_rank(group)
            module.weight = nn.Parameter(p.detach()[r * rows:(r + 1) * rows].clone())
            module.tp_group = group
    return model


def _tp_modules(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, "tp_group", None) is not None]


def sharded_names(model: nn.Module) -> set[str]:
    """The names of the parameters that hold this rank's rows only."""
    return {f"{name}.weight" if name else "weight" for name, _ in _tp_modules(model)}


@torch.no_grad()
def full_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer | None = None):
    """``model``'s ``state_dict`` and ``optimizer``'s with every shard
    gathered back to its full parameter (the optimizer's per-parameter
    state of a shard too), as the replicated model's would be; a
    collective: every rank of the model group calls it."""
    mods = dict(_tp_modules(model))
    sd = model.state_dict()
    for name, m in mods.items():
        key = f"{name}.weight" if name else "weight"
        sd[key] = _all_gather(sd[key], m.tp_group, 0)
    if optimizer is None:
        return sd, None
    osd = optimizer.state_dict()
    params = (p for g in optimizer.param_groups for p in g["params"])
    index = {id(p): i for i, p in enumerate(params)}
    for m in mods.values():
        i = index[id(m.weight)]
        if i in osd["state"]:  # a new dict: state_dict() shares the live one
            osd["state"][i] = {k: (_all_gather(t, m.tp_group, 0) if torch.is_tensor(t)
                                   and t.shape == m.weight.shape else t)
                               for k, t in osd["state"][i].items()}
    return sd, osd


@torch.no_grad()
def replicated_grads_equal(model: nn.Module) -> bool:
    """Whether every gradient of a parameter that is not sharded is the same
    on every rank of the model group, bit for bit (a collective)."""
    mods = _tp_modules(model)
    if not mods:
        return True
    group = mods[0][1].tp_group
    sharded = sharded_names(model)
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None else p.new_zeros(p.numel())
                      for n, p in model.named_parameters() if n not in sharded])
    return all(torch.equal(part, flat) for part in _all_gather(flat[None], group, 0))
