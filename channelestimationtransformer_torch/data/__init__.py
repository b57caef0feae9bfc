from .windows import WindowDataset, make_batch, sample_windows

__all__ = ["WindowDataset", "make_batch", "sample_windows"]
