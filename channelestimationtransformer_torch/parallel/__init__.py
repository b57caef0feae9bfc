"""Data, tensor and sequence parallelism on ``torch.distributed`` (JAX
counterpart ``parallel/``): process-group launch, the ``(data, model, seq)``
device mesh, parameter sharding rules, ring attention and the data-parallel
collectives of the training step."""

from .mesh import AXES, batch_sharding, make_mesh, replicate_sharding

__all__ = ["AXES", "batch_sharding", "make_mesh", "replicate_sharding"]
