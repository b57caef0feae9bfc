"""Number-format descriptors (reference ``qtorch/number.py:12-133``).

The port's own copy of the JAX package's ``ops/quant/formats.py``: same
fields, same checks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """Fixed point with ``wl`` total bits, ``fl`` fractional bits
    (reference ``number.py:44-79``). ``clamp``: saturate to the representable
    range; ``symmetric``: drop the most negative code."""

    wl: int
    fl: int
    clamp: bool = True
    symmetric: bool = False

    def __post_init__(self):
        if self.wl <= 0:
            raise ValueError(f"wl must be positive, got {self.wl}")

    @property
    def resolution(self) -> float:
        return 2.0 ** (-self.fl)

    @property
    def t_min(self) -> float:
        """Lower clamp bound (reference ``sim_helper.cpp:5-13`` fixed_min_max)."""
        t = -(2.0 ** (self.wl - self.fl - 1))
        return t + self.resolution if self.symmetric else t

    @property
    def t_max(self) -> float:
        return (2.0 ** (self.wl - self.fl - 1)) - self.resolution


@dataclasses.dataclass(frozen=True)
class FloatingPoint:
    """Low-bit float with ``exp`` exponent and ``man`` mantissa bits
    (reference ``number.py:82-115``)."""

    exp: int
    man: int

    def __post_init__(self):
        if not (8 >= self.exp > 0 and 23 >= self.man >= 0):
            raise ValueError(f"need 0 < exp <= 8 and 0 <= man <= 23, got {self.exp}, {self.man}")


@dataclasses.dataclass(frozen=True)
class BlockFloatingPoint:
    """Block floating point: shared exponent over the whole tensor (``dim=-1``)
    or per-slice along ``dim`` (reference ``number.py:12-41``)."""

    wl: int
    dim: int = -1
