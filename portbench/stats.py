"""The window's statistics: a rate over all the work and all the time of the
window, and a tail over all its requests. Neither is a median of chunks, so
a stall anywhere in the window moves both."""

from __future__ import annotations

import math


def rate(units: float, seconds: float) -> float:
    """Units of work completed in the window over the window's seconds."""
    return units / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]
