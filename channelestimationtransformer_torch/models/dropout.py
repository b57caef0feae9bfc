"""Dropout drawn from an explicit ``torch.Generator`` (flax ``nn.Dropout``
semantics), so a training step's masks follow from its generator's seed and
never from the global RNG."""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale kept ones by
    ``1 / (1 - rate)``, in ``x``'s dtype: ``x / (1 - rate)`` is rounded once,
    as flax's ``where(mask, x / keep_prob, 0)``, and the 0/1 mask multiplies
    exactly (a bf16 mask scaled by ``1 / keep_prob`` would round the scale
    first). The mask is drawn in f32 whatever ``x``'s dtype, so a generator
    gives a bf16 model the masks it gives the f32 model, as flax's are
    independent of the dtype. The identity in eval mode or at rate 0.
    Raises in training without a generator."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator (generator=...)")
    keep = 1.0 - rate
    mask = torch.empty_like(x, dtype=torch.float32).bernoulli_(keep, generator=generator)
    return x.div(keep).mul_(mask)
