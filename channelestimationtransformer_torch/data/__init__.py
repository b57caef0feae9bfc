from .packing import (
    awgn,
    channel_norm,
    complex_to_real,
    from_ri,
    real_to_complex,
    ri_abs2,
    ri_awgn,
    ri_channel_norm,
    ri_pack,
    to_ri,
)
from .windows import WindowDataset, make_batch, pack_features, sample_windows

__all__ = [
    "awgn",
    "channel_norm",
    "complex_to_real",
    "from_ri",
    "real_to_complex",
    "ri_abs2",
    "ri_awgn",
    "ri_channel_norm",
    "ri_pack",
    "to_ri",
    "WindowDataset",
    "make_batch",
    "pack_features",
    "sample_windows",
]
