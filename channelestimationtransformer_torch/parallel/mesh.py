"""The ``(data, model, seq)`` device mesh and its placements (JAX
counterpart ``parallel/mesh.py``).

- ``data``: batch sharding. Each rank draws its own sub-batch, and the
  training step all-reduces the BatchNorm statistics, the loss's power and
  the gradients over this axis (``train/trainer.py:train_chunk_dp``).
- ``model``: tensor-parallel sharding of the parameters' output features
  (``parallel/sharding.py``).
- ``seq``: sequence sharding of the encoder's self-attention
  (``parallel/ring.py``, ``InformerConfig(attn="ring")``).

The mesh spans every rank of the process group that
``parallel/launch.py`` joined, one device each. JAX's
``ensure_virtual_devices`` (N virtual CPU devices in one process) has no
counterpart: N local ranks come from ``launch.run_local``.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model", "seq")


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1) -> DeviceMesh:
    """A ``(data, model, seq)`` mesh over every rank of the process group, on
    the card under NCCL and on the CPU under gloo. ``data=None`` absorbs all
    remaining ranks into the data axis."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if n % (model * seq) != 0:
            raise ValueError(f"{n} devices not divisible by model*seq={model * seq}")
        data = n // (model * seq)
    if data * model * seq != n:
        raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: join one with "
                           "parallel.launch.initialize_distributed or init_group first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model, seq), mesh_dim_names=AXES)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Placements that shard the leading (batch) dim over the ``data`` axis
    and replicate over the others (JAX ``P("data")``)."""
    from torch.distributed.tensor import Replicate, Shard  # ~1 s to import: only here

    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicate_sharding(mesh: DeviceMesh) -> tuple:
    """Fully replicated placements (parameters, optimizer state, scalars)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim
