from .config import DataConfig, InformerConfig, TrainConfig
from .metrics import nmse, nmse_db, nmse_split
from .runtime import resolve_device

__all__ = [
    "DataConfig",
    "InformerConfig",
    "TrainConfig",
    "nmse",
    "nmse_db",
    "nmse_split",
    "resolve_device",
]
