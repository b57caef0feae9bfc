from .config import (
    DataConfig,
    InformerConfig,
    RecurrentConfig,
    TrainConfig,
    TransformerConfig,
    activation_dtype,
    full_precision_config,
)
from .metrics import nmse, nmse_db, nmse_split
from .runtime import resolve_device, stream_generator

__all__ = [
    "DataConfig",
    "InformerConfig",
    "RecurrentConfig",
    "TrainConfig",
    "TransformerConfig",
    "activation_dtype",
    "full_precision_config",
    "nmse",
    "nmse_db",
    "nmse_split",
    "resolve_device",
    "stream_generator",
]
