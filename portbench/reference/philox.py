"""The attention-dropout keep mask, recomputed in plain torch.

The program drops attention probabilities with a stateless Philox4x32-10
mask keyed by a seed that it draws from the step's generator (one int64 a
call). The reference draws the same seed from the same generator and
recomputes the mask here, from the published algorithm (Random123's
Philox4x32-10) and the layout the program documents:

    key     = (seed & 0xffffffff, seed >> 32)
    counter = (col // 4, row, b * H + h, 0)     row: query, col: key position
    word    = output word ``col % 4``
    keep    = word < min(int(keep_prob * 2**32), 2**32 - 1)
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One call's seed: a 1-element int64 drawn from ``generator``."""
    return torch.randint(0, 2**63 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def _mulhilo(a: int, b: torch.Tensor):
    # a * b needs 64 bits; split a into 16-bit halves so no partial product
    # leaves int64.
    mid = b * (a >> 16)
    t = b * (a & 0xFFFF) + ((mid & 0xFFFF) << 16)
    return (mid >> 16) + (t >> 32), t & _MASK32


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W[0]) & _MASK32
            k1 = (k1 + _W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, b: int, h: int, l_q: int, l_k: int,
              keep_prob: float) -> torch.Tensor:
    """``[B, H, l_q, l_k]`` bool: True where the probability is kept."""
    s = seed.reshape(()).to(torch.int64)
    dev = s.device
    groups = (l_k + 3) // 4
    c0, c1, c2 = torch.broadcast_tensors(
        torch.arange(groups, device=dev).view(1, 1, groups),
        torch.arange(l_q, device=dev).view(1, l_q, 1),
        torch.arange(b * h, device=dev).view(b * h, 1, 1))
    words = philox(c0, c1, c2, torch.zeros_like(c0), s & _MASK32, (s >> 32) & _MASK32)
    words = torch.stack(words, dim=-1).reshape(b, h, l_q, 4 * groups)[..., :l_k]
    threshold = min(int(keep_prob * float(1 << 32)), (1 << 32) - 1)
    return words < threshold
