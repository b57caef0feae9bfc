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
``DenseLSQ``, ``TokenEmbedding`` and the distilling ``ConvLayer``. Every
other layer that holds a ``Shard(0)`` parameter (the recurrent cells, the
recurrent predictor's ``nn.Linear``s, ``ConvLSQ``) keeps its rows and
all-gathers the full weight where its forward uses it (:func:`full_param`),
as GSPMD does around an op it cannot split, such as a fused recurrent scan;
the gather's backward takes the rank's rows of the gradient. Reading the
attribute itself gives the rows, as in a column-parallel layer.

A checkpoint holds the gathered parameters (:func:`full_state_dicts`);
:func:`local_state_dicts` takes this rank's rows back out of one.
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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, y.shape[dim]
        return _all_gather(y, group, dim)

    @staticmethod
    def backward(ctx, grad):
        # Every rank's use of the gathered tensor is the same replicated
        # computation: its gradient is the rank's slice of the whole one.
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def sum_grad_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, whose gradient under autograd is summed over ``group``
    (each rank's use of it is a part of one sum)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _CopyToGroup.apply(t, group)
    return t


def gather_rows(w: torch.Tensor, group) -> torch.Tensor:
    """The full tensor from every rank's rows (dim 0) of ``group``, in rank
    order; under autograd each rank's gradient is its rows of the full one's."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _Gather.apply(w, group, 0)
    return _all_gather(w, group, 0)


def column_parallel(fn, x: torch.Tensor, group) -> torch.Tensor:
    """``fn`` (a product with the rank's output rows of a weight) on the
    replicated ``x``, its output gathered along the last dim in rank order.
    Under autograd each rank's output gradient is its slice, and the
    gradient of ``x`` is summed over ``group``."""
    return _Gather.apply(fn(sum_grad_over(x, group)), group, -1)


def full_param(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered from the ranks' rows
    (a collective over ``module.tp_group``) where :func:`tensor_parallel`
    sharded it, else the parameter itself."""
    p = getattr(module, name)
    if name in getattr(module, "tp_sharded", ()):
        return gather_rows(p, module.tp_group)
    return p


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Turn ``model`` into its tensor-parallel form over ``mesh``'s
    ``model`` axis, in place: every parameter that ``param_shardings``
    places at ``Shard(0)`` keeps this rank's rows; a layer that declares
    ``tp_group`` runs its ``weight`` column-parallel, any other layer
    gathers the full parameter where it uses it (:func:`full_param`). Every
    rank must hold the same full parameters before (the caller broadcasts
    them). A model axis of one changes nothing."""
    group = mesh.get_group("model")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return model
    placements = param_shardings(model, mesh)
    for mod_name, module in model.named_modules():
        names = [name for name in module._parameters
                 if not placements[_join(mod_name, name)].is_replicate()]
        if not names:
            continue
        for name in names:
            rows = module._parameters[name].shape[0] // n
            shard = module._parameters[name].detach()[r * rows:(r + 1) * rows].clone()
            module._parameters[name] = nn.Parameter(shard)
        module.tp_group, module.tp_sharded = group, tuple(names)
    return model


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _tp_modules(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, "tp_group", None) is not None]


def _sharded(model: nn.Module):
    """``(full name, module, parameter name)`` of every sharded parameter."""
    return [(_join(mod_name, name), m, name) for mod_name, m in _tp_modules(model)
            for name in m.tp_sharded]


def sharded_names(model: nn.Module) -> set[str]:
    """The names of the parameters that hold this rank's rows only."""
    return {key for key, _, _ in _sharded(model)}


def _optimizer_index(optimizer) -> dict:
    params = (p for g in optimizer.param_groups for p in g["params"])
    return {id(p): i for i, p in enumerate(params)}


@torch.no_grad()
def full_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer | None = None):
    """``model``'s ``state_dict`` and ``optimizer``'s with every shard
    gathered back to its full parameter (the optimizer's per-parameter
    state of a shard too), as the replicated model's would be; a
    collective: every rank of the model group calls it."""
    sd = model.state_dict()
    osd = None if optimizer is None else optimizer.state_dict()
    index = {} if optimizer is None else _optimizer_index(optimizer)
    for key, m, name in _sharded(model):
        sd[key] = _all_gather(sd[key], m.tp_group, 0)
        p = m._parameters[name]
        i = index.get(id(p))
        if osd is not None and i in osd["state"]:  # a new dict: state_dict() shares the live one
            osd["state"][i] = {k: (_all_gather(t, m.tp_group, 0) if torch.is_tensor(t)
                                   and t.shape == p.shape else t)
                               for k, t in osd["state"][i].items()}
    return sd, osd


def local_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer | None, sd: dict,
                      osd: dict | None = None):
    """The inverse of :func:`full_state_dicts`: from a gathered model
    ``state_dict`` (keys it lacks are left out) and optimizer ``state_dict``,
    this rank's rows of every sharded parameter and of its per-parameter
    optimizer state (Adam's ``exp_avg`` / ``exp_avg_sq``), everything else
    as it is. No collective: every rank reads the same file."""
    sd = dict(sd)
    if osd is not None:
        osd = dict(osd, state=dict(osd["state"]))
    index = {} if optimizer is None else _optimizer_index(optimizer)
    for key, m, name in _sharded(model):
        if key not in sd:
            continue
        full = sd[key].shape
        n = full[0] // dist.get_world_size(m.tp_group)
        rows = slice(dist.get_rank(m.tp_group) * n, (dist.get_rank(m.tp_group) + 1) * n)
        sd[key] = sd[key][rows]
        i = index.get(id(m._parameters[name]))
        if osd is not None and i in osd["state"]:
            osd["state"][i] = {k: (t[rows] if torch.is_tensor(t) and t.shape == full else t)
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
