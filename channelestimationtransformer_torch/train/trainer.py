"""Validation (serving) path of the trainer: draw windows -> channelnorm ->
AWGN -> decoder input -> forward in eval mode -> NMSE.

JAX counterpart: ``train/trainer.py:eval_step_impl`` and ``eval_chunk``,
which ``Trainer.run_validation`` runs. Everything stays on the dataset's
device; results come back as tensors, with no host synchronisation inside.
The training step is the next slice of the port.
"""

from __future__ import annotations

import torch

from ..core.metrics import nmse, nmse_split
from ..data.windows import WindowDataset, make_batch


def _predict(model, x_enc, x_dec):
    out = model(x_enc, x_dec)
    return out[0] if isinstance(out, tuple) else out  # output_attention configs


@torch.no_grad()
def eval_step(model, dataset: WindowDataset, *, batch_size: int, label_len: int,
              **draws) -> dict:
    """Per-horizon NMSE (``split``) and scalar NMSE (``nmse``) of one batch
    of fresh windows. ``draws`` go to :func:`make_batch` (``generator``, or
    injected ``idx``/``starts``/``noise``)."""
    model.eval()
    x_enc, x_dec, target = make_batch(dataset, batch_size, label_len, **draws)
    pred = _predict(model, x_enc, x_dec)
    return {"split": nmse_split(pred, target), "nmse": nmse(pred, target)}


@torch.no_grad()
def eval_chunk(model, dataset: WindowDataset, *, num_batches: int, batch_size: int,
               label_len: int, generator: torch.Generator) -> dict:
    """The mean of :func:`eval_step`'s ``nmse`` and ``split`` over
    ``num_batches`` batches drawn from ``generator``."""
    nmses, splits = [], []
    for _ in range(num_batches):
        m = eval_step(model, dataset, batch_size=batch_size, label_len=label_len,
                      generator=generator)
        nmses.append(m["nmse"])
        splits.append(m["split"])
    return {"nmse": torch.stack(nmses).mean(), "split": torch.stack(splits).mean(dim=0)}
