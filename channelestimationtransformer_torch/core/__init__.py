from .config import DataConfig, InformerConfig, TrainConfig, activation_dtype
from .metrics import nmse, nmse_db, nmse_split
from .runtime import resolve_device, stream_generator

__all__ = [
    "DataConfig",
    "InformerConfig",
    "TrainConfig",
    "activation_dtype",
    "nmse",
    "nmse_db",
    "nmse_split",
    "resolve_device",
    "stream_generator",
]
