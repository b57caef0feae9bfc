"""Everything a run draws from ``--seed``: the weights, the dataset, the
generators of the training steps and the draws of the serving requests.

Each stream is keyed by ``(seed, stream, *index)`` through numpy's
``SeedSequence``, so a stream depends on its key alone and any whole number
a caller passes (beyond 32 bits too) seeds it. Every seed gets the same
sizes: only the values change.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, DATA, TRAIN, SERVE, SAMPLE = 1, 2, 3, 4, 5


def key(seed: int, *path: int) -> int:
    """A 64-bit seed for ``(seed, *path)``."""
    words = np.random.SeedSequence([int(seed), *path]).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


def generator(device, seed: int, *path: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, *path)``."""
    return torch.Generator(device=device).manual_seed(key(seed, *path))


def dataset(config: dict, seed: int, device) -> torch.Tensor:
    """The channel dataset ``[samples, slots, features]``, standard normal,
    drawn on ``device`` in one call."""
    data = config["data"]
    gen = generator(device, seed, DATA)
    return torch.randn((data["samples"], data["slots"], data["features"]), generator=gen,
                       device=device)


# How the benchmark draws each kind of leaf from a standard normal z: dense
# and conv kernels as flax's fan-in initialisers (lecun; kaiming for the
# token embedding) cut at two deviations; biases, norm parameters and
# BatchNorm statistics away from their identity values, so that every term
# of the forward counts.
def _leaf(kind: str, z: torch.Tensor, shape) -> torch.Tensor:
    if kind in ("dense", "conv", "conv_kaiming"):
        fan_in = int(np.prod(shape[1:]))
        scale = 2.0 if kind == "conv_kaiming" else 1.0
        return z.clamp(-2.0, 2.0) * (np.sqrt(scale / fan_in) / 0.8796256610342398)
    if kind in ("bias", "norm_bias"):
        return 0.02 * z
    if kind == "norm_weight":
        return 1.0 + 0.05 * z
    if kind == "running_mean":
        return 0.05 * z
    if kind == "running_var":
        return torch.exp(0.1 * z)
    raise ValueError(f"unknown leaf kind {kind!r}")


def weights(spec, seed: int, device) -> dict:
    """Every leaf of ``spec`` (``(name, shape, kind)``, float32), from one
    standard-normal draw on ``device`` sliced leaf by leaf."""
    sizes = [int(np.prod(shape)) for _, shape, kind in spec if kind != "count"]
    z = torch.randn(sum(sizes), generator=generator(device, seed, WEIGHTS), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = int(np.prod(shape))
        out[name] = _leaf(kind, z[at:at + n].view(shape), shape)
        at += n
    return out


def serve_draws(config: dict, batch: int, count: int, seed: int, device) -> list:
    """The draws ``(idx, starts, noise)`` of ``count`` distinct requests of
    ``batch`` windows, one generator a request."""
    data = config["data"]
    model = config["model"]
    length = model["seq_len"] + model["pred_len"]
    out = []
    for r in range(count):
        gen = generator(device, seed, SERVE, r)
        idx = torch.randint(0, data["samples"], (batch,), generator=gen, device=device)
        starts = torch.randint(0, data["slots"] - length + 1, (batch,), generator=gen,
                               device=device)
        noise = torch.randn((batch, data["slots"], data["features"]), generator=gen,
                            device=device)
        out.append((idx, starts, noise))
    return out
