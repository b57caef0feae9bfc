"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them. Used by ``calibrate.py`` on the card
and by the tests on the CPU; a benchmark run never plants one.

- ``state_unchanged`` (training): the optimizer never steps; the state the
  step returns is the one it was given.
- ``half_batch``: training takes the loss over the first half of the batch
  alone; serving predicts the first half of a request's windows and returns
  those predictions for the second half too.
- ``answer_altered`` (serving): one window's prediction of every request
  comes out negated where the model produces it.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = {"train": ("state_unchanged", "half_batch"),
          "serve": ("half_batch", "answer_altered")}


def _half(t: torch.Tensor) -> torch.Tensor:
    h = t.shape[0] // 2
    return torch.cat([t[:h], t[:h], t[2 * h:]])


@contextlib.contextmanager
def plant(name: str, kind: str):
    """Inside the block the program carries the fault ``name``."""
    from channelestimationtransformer_torch.data import windows
    from channelestimationtransformer_torch.models import informer
    from channelestimationtransformer_torch.train import trainer

    if name not in FAULTS[kind]:
        raise ValueError(f"no fault {name!r} for {kind}")
    if (kind, name) == ("train", "state_unchanged"):
        def step(state):
            state.step += 1
        patch = mock.patch.object(trainer, "apply_gradients", step)
    elif (kind, name) == ("train", "half_batch"):
        nmse = trainer.nmse

        def half_loss(pred, target):
            h = pred.shape[0] // 2
            return nmse(pred[:h], target[:h])
        patch = mock.patch.object(trainer, "nmse", half_loss)
    elif name == "half_batch":
        make_batch = windows.make_batch

        def half_rows(*args, **kwargs):
            return tuple(_half(t) for t in make_batch(*args, **kwargs))
        patch = mock.patch.object(windows, "make_batch", half_rows)
    else:
        forward = informer.InformerBase.forward

        def altered(self, *args, **kwargs):
            out = forward(self, *args, **kwargs).clone()
            out[0] = -out[0]
            return out
        patch = mock.patch.object(informer.InformerBase, "forward", altered)
    with patch:
        yield
