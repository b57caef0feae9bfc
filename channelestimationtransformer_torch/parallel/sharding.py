"""Parameter sharding rules for tensor parallelism (JAX counterpart
``parallel/sharding.py``).

Shape-driven, as JAX's: a weight shards its output features over the
``model`` axis when they divide evenly (and at least two rows fall to each
rank); everything else replicates. The port's layouts put the output
features in dim 0: an ``nn.Linear`` weight is ``[out, in]`` (flax's Dense
kernel ``[in, out]``) and a conv weight ``[C_out, C_in, K]`` (flax's
``[K, C_in, C_out]``), so dim 0 here is the dim JAX shards last. Biases,
norm scales and scalars replicate.

A forward or a training step with tensor-parallel parameters is not ported
(ROADMAP Queue 1); :func:`shard_params` places the parameters.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor


def infer_param_spec(name: str, value: torch.Tensor, model_size: int) -> Placement:
    """The placement of one parameter over the ``model`` axis."""
    if model_size <= 1 or value.ndim == 0:
        return Replicate()
    if value.ndim >= 2 and value.shape[0] % model_size == 0 and value.shape[0] >= 2 * model_size:
        return Shard(0)
    return Replicate()


def param_shardings(model: nn.Module, mesh: DeviceMesh) -> dict[str, Placement]:
    """Each named parameter's placement over ``mesh``'s ``model`` axis."""
    model_size = mesh["model"].size()
    return {name: infer_param_spec(name, p, model_size) for name, p in model.named_parameters()}


def shard_params(model: nn.Module, mesh: DeviceMesh) -> dict[str, DTensor]:
    """Each named parameter as a DTensor over the ``model`` sub-mesh, placed
    by :func:`param_shardings` (every rank holds the same full values)."""
    sub = mesh["model"]
    placements = param_shardings(model, mesh)
    return {name: distribute_tensor(p.detach(), sub, [placements[name]])
            for name, p in model.named_parameters()}
